"""The build options that default to off (``BuildOptions``: ``beam_expand``,
``traverse``, ``link_slack``, ``chain_seeding`` / ``refine_iters``, the
``bulk_*`` settings, ``bulk_upper``, ``bulk_backbone``, ``backbone_flat``,
``bulk_renumber``) in the port against the JAX package, on the CPU.

* ``BuildOptions`` has the JAX package's fields, in its order, with its
  defaults;
* the device steps on states both packages make from the same arrays (a
  port wave build of 1500 x 32 cosine): ``beam_search(expand=,
  traverse_k=)`` gives the JAX package's ids and iterations (distances to
  1e-5), ``wave_insert_level`` with ``expand`` / ``traverse`` / a
  slack-widened table agrees on 98% of its rows as the default wave step
  does (``tests/test_torch_build.py``), and ``prune_slack_rows``,
  ``proto_seed_rows``, ``permute_device`` and ``HostGraph.permute`` give
  the JAX package's arrays exactly;
* every option drives a whole port build to a valid graph that holds the
  recall bar, through the code path it names (its span);
* whole builds against the JAX package's: wave options at 1500 x 32 and
  chain seeding at 6000 x 32 to the default wave build's parity
  (``tests/test_torch_build.py``: 98% of ``links0`` rows, the same levels
  and entry points), the bulk settings at 1500 x 32 to 99.9% of
  ``links0`` rows and equal upper rows, the renumbered bulk build's
  permutation and answers and both Writers' records, and a lockstep build
  with slack record for record. Each compiles the JAX package's build
  programs anew, so those beyond the file's time budget are ``slow``.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import hannoy_tpu
import hannoy_tpu.parallel as jax_parallel
from hannoy_tpu.build import builder as jax_builder
from hannoy_tpu.build import bulk as jax_bulk
from hannoy_tpu.build import wave_ops as jax_wave_ops
from hannoy_tpu.models import hnsw as jax_hnsw
from hannoy_tpu.ops import beam as jax_beam
from hannoy_tpu.ops import distances as jax_distances
import hannoy_tpu_torch
import hannoy_tpu_torch.parallel as parallel
from hannoy_tpu_torch.build import builder, bulk, wave_ops
from hannoy_tpu_torch.models import hnsw
from hannoy_tpu_torch.ops import beam, distances
from hannoy_tpu_torch.utils import tracing

pytest_plugins = ("jax_programs",)  # clears JAX's compiled programs between tests: tests/jax_programs.py

torch.set_num_threads(2)

N, D, M, M0, EFC, WAVE = 1500, 32, 8, 16, 32, 128
N_WAVE, N_QUERIES, K = 128, 64, 10


def _data(n=N, seed=7):
    """``tests/test_torch_build.py``'s data: 16 Gaussian clusters."""
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((16, D)).astype(np.float32) * 2.0
    data = (centers[rng.integers(0, 16, n)] + rng.standard_normal((n, D))).astype(np.float32)
    queries = (centers[rng.integers(0, 16, N_QUERIES)] + rng.standard_normal((N_QUERIES, D))).astype(np.float32)
    return data, queries


def _stage(mod, data, name="cosine"):
    metric = (jax_distances if mod is jax_hnsw else distances).by_name(name)
    n = len(data)
    g = mod.HostGraph.empty(metric, D, M, M0, capacity=jax_hnsw.slot_capacity(n))
    for i in range(n):
        g.alloc_slot(i)
    g.vectors[:n] = data
    g.norms[:n] = jax_distances.np_norms(jax_distances.by_name(name), data)
    return g


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


def _device_state(jdev) -> dict:
    return {
        f: np.asarray(getattr(jdev, f))
        for f in ("vectors", "norms", "links0", "dists0", "upper_links", "upper_dists", "slot_rows", "entry_slots", "valid")
    } | {"metric_name": jdev.metric_name, "max_level": jdev.max_level}


def _both_devs(tg: hnsw.HostGraph, link_slack: int = 0):
    """The JAX device graph of ``tg``'s arrays and the port's copy of it."""
    jdev = jax_hnsw.to_device(_jax_host(tg), link_slack=link_slack, cache=False)
    return jdev, hnsw.device_graph_from_arrays("cpu", **_device_state(jdev))


def _recall(g, data, queries, ef=48) -> float:
    """Tie-aware recall@10 of a port graph against the exact answers."""
    m = jax_distances.by_name(g.metric.name)
    qn = jax_distances.np_norms(m, queries)
    res = beam.hnsw_search(hnsw.to_device(g, "cpu", serve_only=True), torch.from_numpy(queries), torch.from_numpy(qn), ef)
    exact = jax_distances.np_pairwise(m, queries, qn, data, jax_distances.np_norms(m, data))
    kth = np.sort(exact, axis=1)[:, K - 1 : K]
    return float((res.dists.numpy()[:, :K] <= kth + 1e-5 * np.abs(kth) + 1e-6).mean())


def _row_share(a: np.ndarray, b: np.ndarray) -> float:
    return float(np.mean(np.all(a == b, axis=1)))


def test_build_options_match_jax():
    """Every field of the JAX package's ``BuildOptions``, in its order, with
    its default (the cancel closure and progress sink by what they do)."""
    jf, tf = dataclasses.fields(jax_builder.BuildOptions), dataclasses.fields(builder.BuildOptions)
    assert [f.name for f in tf] == [f.name for f in jf]
    j, t = jax_builder.BuildOptions(), builder.BuildOptions()
    for f in jf:
        if f.name == "cancel":
            assert t.cancel() is False and j.cancel() is False
        elif f.name == "progress":
            assert type(t.progress).__name__ == type(j.progress).__name__
        else:
            assert getattr(t, f.name) == getattr(j, f.name), f.name


# --------------------------------------------------------------------------
# (a) the device steps, on states both packages make from the same arrays
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def base():
    """A port wave build of the first N - 128 items (all N staged), the
    queries, and the last 128 items as a wave."""
    data, queries = _data()
    g = _stage(hnsw, data)
    builder.build_graph(g, np.arange(N - N_WAVE, dtype=np.int64), np.empty(0, np.int64),
                        builder.BuildOptions(ef_construction=EFC, wave_size=WAVE, bulk=False), device="cpu")
    assert g.max_level >= 1
    return g, queries, np.arange(N - N_WAVE, N, dtype=np.int32)


@pytest.mark.parametrize("expand, traverse_k, level", [(2, None, 0), (2, 8, 0), (3, 12, 0), (2, None, 1)])
def test_beam_search_expand_and_traverse_match_jax(base, expand, traverse_k, level):
    g, queries, _ = base
    jdev, tdev = _both_devs(g)
    m = jax_distances.COSINE
    qn = jax_distances.np_norms(m, queries)
    start = np.broadcast_to(np.asarray(jdev.entry_slots)[None, :], (N_QUERIES, jdev.entry_slots.shape[0])).copy()
    want = jax_beam.beam_search(jdev, jnp.asarray(queries), jnp.asarray(qn), jnp.asarray(start), 24,
                                level=level, expand=expand, traverse_k=traverse_k)
    got = beam.beam_search(tdev, torch.from_numpy(queries), torch.from_numpy(qn), torch.from_numpy(start), 24,
                           level=level, expand=expand, traverse_k=traverse_k)
    ws, gs = np.asarray(want.slots), got.slots.numpy()
    share = float((ws == gs).mean())
    print(f"beam_search expand={expand} traverse_k={traverse_k} level={level}: identical slots {share:.4f}, "
          f"iters port {int(got.iters)} jax {int(want.iters)}")
    assert share >= 0.99
    same = (ws == gs) & (ws >= 0)
    np.testing.assert_allclose(got.dists.numpy()[same], np.asarray(want.dists)[same], rtol=0, atol=1e-5)
    if share == 1.0:  # the loop ran exactly as the JAX while_loop did
        assert int(got.iters) == int(want.iters)
        np.testing.assert_array_equal(got.active.numpy(), np.asarray(want.active))


@pytest.mark.parametrize("change", [dict(expand=2), dict(traverse=8), dict(link_slack=4)], ids=lambda c: next(iter(c)))
def test_wave_insert_level_options_match_jax(base, change):
    """One level-0 wave of the last 128 items, seeded by the JAX package's
    descent, with each option (the slack case on tables 4 columns wider)."""
    g, _, wave = base
    slack = change.get("link_slack", 0)
    kw = {k: v for k, v in change.items() if k != "link_slack"}
    jdev, tdev = _both_devs(g, slack)
    node_ok = np.asarray(jdev.valid).copy()
    node_ok[wave] = True
    seeds = np.array(jax_beam.descend_for_slots(jdev, jnp.asarray(wave), g.max_level, 1, node_ok=jnp.asarray(node_ok)))
    j_res = jax_wave_ops.wave_insert_level(
        jdev, jnp.asarray(wave), jnp.asarray(seeds), jnp.asarray(node_ok), jnp.int32(0),
        jnp.zeros((jdev.capacity,), bool), jnp.zeros((4,), jnp.int32), is_level0=True, ef=EFC, cap=M0, alpha=1.0, **kw,
    )
    t_res = wave_ops.wave_insert_level(
        tdev, torch.from_numpy(wave), torch.from_numpy(seeds), torch.from_numpy(node_ok), 0,
        torch.zeros(tdev.capacity, dtype=torch.bool), torch.zeros(4, dtype=torch.int32), ef=EFC, cap=M0, alpha=1.0, **kw,
    )
    j_links, t_links = np.asarray(j_res.graph.links0), t_res.graph.links0.numpy()
    assert t_links.shape == (g.capacity, M0 + slack)
    live = node_ok
    sel_share = _row_share(t_res.selected.numpy(), np.asarray(j_res.selected))
    links_share = _row_share(t_links[live], j_links[live])
    print(f"wave_insert_level {change}: selected rows {sel_share:.4f}, links0 rows {links_share:.4f}, "
          f"rows past M0 {int(((t_links[live] >= 0).sum(1) > M0).sum())}")
    assert sel_share >= 0.98 and links_share >= 0.98
    if links_share == 1.0:
        np.testing.assert_array_equal(t_res.dirty.numpy(), np.asarray(j_res.dirty))
        np.testing.assert_array_equal(t_res.counters.numpy(), np.asarray(j_res.counters))


def test_prune_slack_rows_matches_jax(base):
    """Tables 4 columns wider, 400 rows filled with their 20 nearest live
    items (distance-sorted): both prunes give the same rows and dirty mask,
    and rows at or under M0 links stay as they are."""
    g, _, _ = base
    live = np.nonzero(g.valid_mask())[0]
    rows = np.random.default_rng(5).choice(live, 400, replace=False)
    d = jax_distances.np_pairwise(jax_distances.COSINE, g.vectors[rows], g.norms[rows], g.vectors[live], g.norms[live])
    d[np.arange(len(rows)), np.searchsorted(live, rows)] = np.inf  # not itself
    near = np.argsort(d, axis=1, kind="stable")[:, : M0 + 4]
    jdev, _ = _both_devs(g, link_slack=4)
    state = _device_state(jdev)
    state["links0"] = state["links0"].copy()
    state["dists0"] = state["dists0"].copy()
    state["links0"][rows] = live[near]
    state["dists0"][rows] = np.take_along_axis(d, near, axis=1)
    jdev = jax_hnsw.DeviceGraph(**{k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v) for k, v in state.items()})
    tdev = hnsw.device_graph_from_arrays("cpu", **state)
    j_g, j_dirty = jax_wave_ops.prune_slack_rows(jdev, jnp.zeros((g.capacity,), bool), cap=M0, alpha=1.0)
    t_g, t_dirty = wave_ops.prune_slack_rows(tdev, torch.zeros(g.capacity, dtype=torch.bool), cap=M0, alpha=1.0)
    np.testing.assert_array_equal(t_g.links0.numpy(), np.asarray(j_g.links0))
    np.testing.assert_array_equal(t_g.dists0.numpy(), np.asarray(j_g.dists0))
    np.testing.assert_array_equal(t_dirty.numpy(), np.asarray(j_dirty))
    assert t_dirty.numpy()[rows].all() and int(t_dirty.sum()) == len(rows)
    assert ((t_g.links0.numpy() >= 0).sum(1) <= M0).all()


def test_proto_seed_rows_matches_jax(base):
    """Chain seeds of the 128-item wave from 300 earlier items (-1 padded
    to 512): [128, 1 + M0] ids equal."""
    g, _, wave = base
    jdev, tdev = _both_devs(g)
    protos = np.full(512, -1, dtype=np.int32)
    protos[:300] = np.random.default_rng(6).choice(N - N_WAVE, 300, replace=False)
    want = np.asarray(jax_wave_ops.proto_seed_rows(jdev, jnp.asarray(wave), jnp.asarray(protos)))
    got = wave_ops.proto_seed_rows(tdev, torch.from_numpy(wave), torch.from_numpy(protos)).numpy()
    assert got.shape == (N_WAVE, 1 + M0)
    np.testing.assert_array_equal(got, want)


def _permutation(capacity: int) -> tuple[np.ndarray, np.ndarray]:
    perm = np.random.default_rng(8).permutation(capacity).astype(np.int64)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(capacity)
    return perm, inv


def test_permute_device_matches_jax(base):
    g, _, _ = base
    jdev, tdev = _both_devs(g)
    perm, inv = _permutation(g.capacity)
    want = _device_state(jax_hnsw.permute_device(jdev, jnp.asarray(perm.astype(np.int32)), jnp.asarray(inv.astype(np.int32))))
    got = hnsw.permute_device(tdev, torch.from_numpy(perm), torch.from_numpy(inv))
    for f in ("vectors", "norms", "links0", "dists0", "upper_links", "upper_dists", "slot_rows", "entry_slots", "valid"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), want[f], err_msg=f)


def test_host_graph_permute_matches_jax(base):
    g, _, _ = base
    jg, tg = _jax_host(g), hnsw.host_graph_from_arrays(**{
        f.name: getattr(g, f.name) for f in dataclasses.fields(g)
    } | {"metric": g.metric.name})
    perm, _ = _permutation(g.capacity)
    jg.permute(perm)
    tg.permute(perm)
    for f in ("ids", "levels", "vectors", "norms", "links0", "dists0"):
        np.testing.assert_array_equal(getattr(tg, f), getattr(jg, f), err_msg=f)
    for a, b in zip(tg.upper_links + tg.slot_rows, jg.upper_links + jg.slot_rows):
        np.testing.assert_array_equal(a, b)
    assert tg.entry_slots == jg.entry_slots and tg.id_to_slot == jg.id_to_slot
    assert tg.free_slots == jg.free_slots and tg.next_fresh == jg.next_fresh
    tg.check_validity()


# --------------------------------------------------------------------------
# (b) every option through a whole port build
# --------------------------------------------------------------------------

#: (options, the span that shows the option's path ran, BRUTE_MAX or None)
PORT_BUILDS = {
    "beam_expand": (dict(bulk=False, beam_expand=2), "insert_wave", None),
    "traverse": (dict(bulk=False, traverse=8), "insert_wave", None),
    "link_slack": (dict(bulk=False, link_slack=4), "prune_slack_rows", None),
    "bulk_k_rand": (dict(bulk=True, bulk_k=40, bulk_rand=4), "bulk_random_candidates", None),
    "kmeans_random_init": (dict(bulk=True, bulk_cluster_size=256, bulk_init="random"), "bulk_kmeans", 512),
    "beam_backbone": (dict(bulk=True, backbone_flat=False), "insert_wave", None),
    "bulk_upper": (dict(bulk=True, bulk_backbone=False, bulk_upper=1), "bulk_upper_tri", None),
    "bulk_renumber": (dict(bulk=True, bulk_renumber=True), "bulk_renumber", 512),
}


@pytest.mark.parametrize("case", list(PORT_BUILDS))
def test_option_builds_a_valid_graph(case, monkeypatch):
    opts, span_name, brute_max = PORT_BUILDS[case]
    if brute_max:
        monkeypatch.setattr(bulk, "BRUTE_MAX", brute_max)
    data, queries = _data()
    g = _stage(hnsw, data)
    with tracing.record() as spans:
        stats = builder.build_graph(g, np.arange(N, dtype=np.int64), np.empty(0, np.int64),
                                    builder.BuildOptions(ef_construction=EFC, wave_size=WAVE, **opts), device="cpu")
    g.check_validity()
    live = g.valid_mask()
    indeg = np.bincount(g.links0[live][g.links0[live] >= 0], minlength=g.capacity)
    assert (indeg[live] >= 1).all()
    assert span_name in {s.name for s in spans}
    rec = _recall(g, data, queries)
    print(f"{case} {opts}: recall@10 {rec:.4f}, waves {stats.waves}, beam iters {stats.beam_iters}")
    assert rec >= (0.85 if case == "bulk_upper" else 0.9)
    if case == "bulk_renumber":  # the slots were renumbered, the items kept
        assert not np.array_equal(g.ids[:N], np.arange(N))
        assert sorted(g.ids[:N].tolist()) == list(range(N))


def test_chain_seeding_runs_chained_waves():
    """6000 x 32 with wave_size 4096: the layer-0 waves after the first one
    of 1024 items are chain-seeded with the smaller refine budget."""
    data, queries = _data(6000)
    g = _stage(hnsw, data)
    with tracing.record() as spans:
        builder.build_graph(g, np.arange(6000, dtype=np.int64), np.empty(0, np.int64),
                            builder.BuildOptions(ef_construction=EFC, wave_size=4096, chain_seeding=True), device="cpu")
    g.check_validity()
    chained = [s for s in spans if s.name == "insert_wave" and s.fields["chained"]]
    rec = _recall(g, data, queries)
    print(f"chain seeding: {len(chained)} chained waves, recall@10 {rec:.4f}")
    assert len(chained) > 0 and rec >= 0.9


def test_lockstep_slack_build_rechecks_stranded_rows():
    """``build_sharded`` with slack ends every shard with the stranding
    re-check; given a shard row that lost every in-edge, ``recheck_shards``
    gives it one again (the slack prune can take a forced in-edge, and the
    JAX package's sharded builds have no re-check)."""
    rng = np.random.default_rng(3)
    data = rng.standard_normal((800, 16)).astype(np.float32)
    opts = builder.BuildOptions(ef_construction=EFC, link_slack=4)
    with tracing.record() as spans:
        index = parallel.build_sharded(distances.EUCLIDEAN, data, np.arange(800), 8, 16, 2, opts, devices=["cpu"] * 2)
    assert sum(s.name == "inbound_recheck" for s in spans) == 2
    g = index.graphs[1]
    links = g.links0.numpy()
    victim = int(links[0, 0])
    hit = links == victim
    g.links0[torch.from_numpy(hit)] = -1
    g.dists0[torch.from_numpy(hit)] = float("inf")
    g.dists0[:], order = torch.sort(g.dists0, dim=-1, stable=True)
    g.links0[:] = g.links0.gather(1, order)
    node_ok = g.valid.clone()
    waves = parallel.sharded.recheck_shards(index, [None, node_ok], None, 16, opts, [False, True])
    assert waves == [0, 0]
    assert (g.links0.numpy()[g.valid.numpy()] == victim).any()


# --------------------------------------------------------------------------
# (c) whole builds against the JAX package's
# --------------------------------------------------------------------------


def _jax_log():
    """Capture the JAX package's span log (its spans only log) → list."""
    import logging

    msgs: list[str] = []

    class _H(logging.Handler):
        def emit(self, record):
            msgs.append(record.getMessage())

    lg = logging.getLogger("hannoy_tpu")
    h = _H()
    lg.addHandler(h)
    old = lg.level
    lg.setLevel(logging.DEBUG)
    return msgs, lambda: (lg.removeHandler(h), lg.setLevel(old))


def _builds_both(data, opts: dict, n_share: float):
    n = len(data)
    jg = _stage(jax_hnsw, data)
    msgs, restore = _jax_log()
    try:
        jax_builder.build_graph(jg, np.arange(n, dtype=np.int64), np.empty(0, np.int64),
                                jax_builder.BuildOptions(ef_construction=EFC, **opts))
    finally:
        restore()
    tg = _stage(hnsw, data)
    with tracing.record() as spans:
        builder.build_graph(tg, np.arange(n, dtype=np.int64), np.empty(0, np.int64),
                            builder.BuildOptions(ef_construction=EFC, **opts), device="cpu")
    tg.check_validity()
    np.testing.assert_array_equal(tg.levels, jg.levels)
    assert tg.entry_slots == jg.entry_slots and tg.max_level == jg.max_level
    live = tg.valid_mask()
    share = _row_share(tg.links0[live], jg.links0[live])
    upper = [_row_share(a, b) for a, b in zip(tg.upper_links, jg.upper_links)]
    print(f"build {opts}: identical links0 rows {share:.4f}, upper rows {upper}")
    assert share >= n_share
    return tg, jg, upper, spans, msgs


SLOW = pytest.mark.slow


@pytest.mark.parametrize("change", [
    pytest.param(dict(beam_expand=2), marks=SLOW), pytest.param(dict(traverse=8), marks=SLOW), dict(link_slack=4),
], ids=lambda c: next(iter(c)))
def test_wave_option_build_matches_jax(change):
    tg, jg, upper, _, _ = _builds_both(_data()[0], dict(wave_size=WAVE, bulk=False, **change), 0.98)
    assert min(upper) >= 0.98


@pytest.mark.slow
def test_chain_seeded_build_matches_jax():
    tg, jg, upper, spans, msgs = _builds_both(_data(6000)[0], dict(wave_size=4096, chain_seeding=True), 0.98)
    t_chained = sum(1 for s in spans if s.name == "insert_wave" and s.fields["chained"])
    j_chained = sum(1 for m in msgs if m.startswith("insert_wave") and "chained=1" in m)
    assert t_chained == j_chained > 0
    assert min(upper) >= 0.98


@pytest.mark.parametrize("change", [
    pytest.param(dict(bulk_k=40), marks=SLOW), pytest.param(dict(bulk_rand=4), marks=SLOW), pytest.param(dict(bulk_cluster_size=256), marks=SLOW),
    pytest.param(dict(bulk_init="random"), marks=SLOW), pytest.param(dict(backbone_flat=False), marks=SLOW),
    dict(bulk_backbone=False, bulk_upper=1),
], ids=lambda c: "-".join(f"{k}={v}" for k, v in c.items()))
def test_bulk_option_build_matches_jax(change, monkeypatch):
    """k-means settings run with BRUTE_MAX at 512 in both packages."""
    if "bulk_cluster_size" in change or "bulk_init" in change:
        monkeypatch.setattr(jax_bulk, "BRUTE_MAX", 512)
        monkeypatch.setattr(bulk, "BRUTE_MAX", 512)
    _, _, upper, _, _ = _builds_both(_data()[0], dict(bulk=True, **change), 0.999)
    assert upper == [1.0] * len(upper)


def _records(db):
    return dict(db._db.prefix_iter(db._env.read_txn(), b""))


def _assert_records_equal(want, got):
    assert want.keys() == got.keys()
    differ = sorted(k for k in want if want[k] != got[k])
    assert not differ, f"{len(differ)} of {len(want)} records differ, first {differ[:3]}"


@pytest.mark.slow
def test_bulk_renumber_matches_jax(tmp_path, monkeypatch):
    """A renumbered k-means bulk build (3000 x 32): the same permutation as
    the JAX package's, the same answers by item id as the build without
    it, and both Writers leave equal records (the store is keyed by id)."""
    monkeypatch.setattr(jax_bulk, "BRUTE_MAX", 512)
    monkeypatch.setattr(bulk, "BRUTE_MAX", 512)
    monkeypatch.setattr(jax_hnsw, "_SYNC_BF16", False)
    data, queries = _data(3000)
    tg, jg, _, spans, _ = _builds_both(data, dict(bulk=True, bulk_renumber=True), 0.999)
    assert "bulk_renumber" in {s.name for s in spans}
    np.testing.assert_array_equal(tg.ids, jg.ids)  # the same permutation
    plain = _stage(hnsw, data)
    builder.build_graph(plain, np.arange(3000, dtype=np.int64), np.empty(0, np.int64),
                        builder.BuildOptions(ef_construction=EFC, bulk=True), device="cpu")
    qn = torch.from_numpy(distances.np_norms(distances.COSINE, queries))
    answers = []
    for g in (tg, plain):
        res = beam.hnsw_search(hnsw.to_device(g, "cpu", serve_only=True), torch.from_numpy(queries), qn, 48)
        answers.append(g.ids[np.maximum(res.slots.numpy(), 0)])
    np.testing.assert_array_equal(*answers)

    recs = []
    for pkg in (hannoy_tpu, hannoy_tpu_torch):
        kw = {"device": "cpu"} if pkg is hannoy_tpu_torch else {}
        db = pkg.Database(tmp_path / pkg.__name__, pkg.Metric.COSINE, **kw)
        w = db.writer(D, m=M, ef=EFC)
        w.add_items(range(3000), data)
        b = w.builder(seed=42)
        b._opts.bulk_renumber = True  # no builder method in either package
        b.bulk(True).build()
        db.commit_rw_txn()
        recs.append(_records(db))
        db.close()
    _assert_records_equal(*recs)


def test_lockstep_link_slack_records_match_jax(tmp_path, monkeypatch):
    """``tests/test_spmd_build.py``'s 800 x 16 euclidean in 8 shards through
    the lockstep build with ``link_slack=4``, then 24 added and 16 deleted
    by another: equal records under every key."""
    monkeypatch.setattr(jax_hnsw, "_SYNC_BF16", False)
    rng = np.random.default_rng(1)
    centers = rng.standard_normal((12, 16)).astype(np.float32) * 3.0
    data = (centers[rng.integers(0, 12, 824)] + rng.standard_normal((824, 16))).astype(np.float32)
    recs = []
    for pkg in (hannoy_tpu, hannoy_tpu_torch):
        torch_pkg = pkg is hannoy_tpu_torch
        P, B = (parallel, builder) if torch_pkg else (jax_parallel, jax_builder)
        layout = {"devices": ["cpu"] * 8} if torch_pkg else {"mesh": jax_parallel.make_mesh(8)}
        db = pkg.Database(tmp_path / pkg.__name__, pkg.Metric.EUCLIDEAN, **({"device": "cpu"} if torch_pkg else {}))
        for add, drop in ((range(800), ()), (range(800, 824), range(16))):
            w = P.ShardedWriter(db, 16, n_shards=8, m=8, ef=48, **layout)
            w.add_items(add, data[list(add)])
            for i in drop:
                assert w.del_item(i)
            w.build(spmd=True, opts=B.BuildOptions(ef_construction=48, link_slack=4))
            db.commit_rw_txn()
        recs.append(_records(db))
        db.close()
    _assert_records_equal(*recs)
