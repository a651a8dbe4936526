"""The hamming deployment on the CPU: the plain reference against the codec's
own lanes, the port's answers against the reference at the deployment's
width, the packed plain walk's row count by hand, and the cell's files
found by name."""

import tempfile
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from annbench import harness, packed_control, plain_packed, reference
from annbench.yardstick import recall as yrecall
from annbench.yardstick import trace as ytrace
from annbench.yardstick.layers import NothingToRead

from conftest import TINY

CELL = "ada002-hamming-999k.search-b256"
DIM = 1536


def _rows(n, seed, d=DIM):
    """Gaussian rows with exact zeros, an all-zero row and an all-negative row."""
    x = np.random.default_rng(seed).standard_normal((n, d)).astype(np.float32)
    x[:, ::7] = 0.0
    x[0] = 0.0
    x[1] = -np.abs(x[1]) - 1.0
    return x


def _codec_hamming(a, b):
    """popcount(a ^ b) / (lanes · 32) of ``codecs.pack``'s uint32 lanes, in numpy."""
    from hannoy_tpu_torch.ops import codecs

    pa, pb = codecs.pack(a, codecs.BINARY), codecs.pack(b, codecs.BINARY)
    xor = pa[:, None, :] ^ pb[None, :, :]
    pc = np.unpackbits(xor.astype("<u4").view(np.uint8), axis=2).sum(axis=2)
    return pc / float(pa.shape[1] * 32)


def test_reference_equals_the_codecs_popcount_exactly():
    dist = reference.distance("hamming")
    for d in (DIM, 100):  # 100 bits: padded with zeros to 128
        q, x = _rows(9, 1, d), _rows(40, 2, d)
        want = _codec_hamming(q, x)
        got = dist.pairwise(torch.from_numpy(q).double(), torch.from_numpy(x).double()).numpy()
        assert np.array_equal(got, want)
        row = dist.rowwise(torch.from_numpy(q).double(), torch.from_numpy(x[:9]).double()).numpy()
        assert np.array_equal(row, np.diagonal(want))
    assert dist.padded_bits(DIM) == DIM


def test_plain_packing_equals_the_codecs_lanes():
    from hannoy_tpu_torch.ops import codecs, distances

    x = _rows(5, 3, 100)
    assert np.array_equal(plain_packed.pack(torch.from_numpy(x)).numpy(),
                          distances.as_lanes(codecs.pack(x, codecs.BINARY)))


def test_the_port_answers_with_the_reference_distance_at_the_deployments_width():
    cell = harness.load_cell(CELL, sizes={"n_items": 2000, "query_pool": 64, "map_size_gib": 0.25})
    assert cell.config["dimensions"] == DIM and (cell.config["m"], cell.config["ef_construction"]) == (16, 64)
    data = harness.make_data(cell, 2**31 + 19, "cpu")
    k, ef = cell.config["nns"], cell.config["ef_search"]
    with tempfile.TemporaryDirectory() as store:
        index = harness.build_index(cell, data, 19, store, "cpu", "raw")
        found = index.reader.nns(k).ef_search(ef).by_vectors(data.queries.numpy())
        index.db.close()
    ids = torch.tensor([[i for i, _ in s.nns] for s in found])
    got = torch.tensor([[d for _, d in s.nns] for s in found], dtype=torch.float64)
    assert ids.shape == (64, k)
    dist = reference.distance("hamming")
    items = data.items.double()
    qidx = torch.arange(64).repeat_interleave(k)
    ref = reference.distances_of(dist, data.queries.double(), items, qidx, ids.flatten()).view(64, k)
    ulp = torch.from_numpy(np.spacing(ref.float().numpy())).double()
    assert bool(((got - ref).abs() <= ulp).all())
    kth = reference.exact_topk(dist, data.queries, items, k)[:, k - 1]
    assert float(yrecall.recall_per_row(ref, kth, k).mean()) >= 0.95


def test_the_packed_control_fails_the_distances_alone_where_the_bf16_tier_cannot():
    """At the deployment's width, where most distances k / 1536 are no
    bfloat16 numbers: the program's bfloat16 tier holds the same lanes and
    comes out as the sound run, the control (the answers' distances in
    bfloat16) fails ``dist_gap`` and no other number."""
    sizes = {"n_items": 2000, "query_pool": 384, "map_size_gib": 0.25}
    tier = harness.run_cell(CELL, 12, 0.5, False, device="cpu", sizes=sizes, tier="bf16")
    assert tier["correct"], tier["checks"]
    r = packed_control.run(CELL, 12, 0.5, device="cpu", sizes=sizes)
    checks = r["checks"]
    assert not r["correct"]
    assert checks["dist_gap"]["value"] > checks["dist_gap"]["limit"]
    assert all(c["value"] <= c["limit"] for name, c in checks.items() if name != "dist_gap"), checks


def _toy_graph():
    """Six items on a line of 64 bits (item i: its first 4i bits set) in
    three levels: entry 0; level 2 holds 0 and 3, level 1 holds 0, 3 and 4;
    layer 0 is the chain 0-1-2-3-4-5."""
    x = np.zeros((6, 64), dtype=np.float32) - 1.0
    for i in range(6):
        x[i, : 4 * i] = 1.0
    lanes = plain_packed.pack(torch.from_numpy(x))
    links0 = torch.full((6, 4), -1, dtype=torch.int32)
    for i in range(6):
        nbs = [j for j in (i - 1, i + 1) if 0 <= j < 6]
        links0[i, : len(nbs)] = torch.tensor(nbs)
    slot_rows = torch.full((2, 6), -1, dtype=torch.int32)
    upper = torch.full((2, 3, 2), -1, dtype=torch.int32)
    for level, rows in ((1, {0: [3], 3: [0, 4], 4: [3]}), (2, {0: [3], 3: [0]})):
        for r, (slot, nbs) in enumerate(rows.items()):
            slot_rows[level - 1, slot] = r
            upper[level - 1, r, : len(nbs)] = torch.tensor(nbs)
    return SimpleNamespace(vectors=lanes, links0=links0, upper_links=upper, slot_rows=slot_rows,
                           entry_slots=torch.tensor([0], dtype=torch.int32), valid=torch.ones(6, dtype=torch.bool),
                           max_level=2)


def test_packed_plain_walk_counts_the_rows_a_hand_walk_reads():
    """The query has its first 20 bits set: item 5 is at 0 bits, item i at
    |20 - 4i|. Level 2: from 0 to 3 (reads rows 0 and 3, upper rows of 0
    and 3). Level 1: from 3 to 4 (reads 4; upper rows of 3 and 4). Layer 0
    at ef 2 from 4: expands 4 (reads 3, 5), then 5 (its one link is pooled):
    store rows {0, 3, 4, 5}, link rows {4, 5}, upper rows 4."""
    q = torch.full((1, 64), -1.0)
    q[0, :20] = 1.0
    rows = plain_packed.rows_read(_toy_graph(), q, 2)
    assert rows == (4, 2, 4)
    assert plain_packed.bytes_read(rows, 64, 4, 2, 1) == 4 * 8 + 2 * 4 * 4 + 4 * (4 * 2 + 4) + 8
    assert plain_packed.bytes_read(plain_packed.RowsRead(1, 0, 0), DIM, 32, 16, 0) == 192


def test_the_cell_loads_by_name_with_its_limits():
    cell = harness.load_cell(CELL)
    cfg = cell.config
    assert (cfg["metric"], cfg["tier"], cfg["dimensions"], cfg["n_items"]) == ("hamming", "raw", DIM, 999_000)
    assert (cfg["m"], cfg["m0"], cfg["ef_construction"], cfg["ef_search"], cfg["nns"]) == (16, 32, 64, 100, 10)
    assert cfg["reduced"] == [] and cell.mix["batch"] == 256
    assert set(cell.limits) == {"dist_gap", "bad_rows", "miss_share"}
    assert {m["name"] for m in cell.end_to_end} == {"search_qps", "search_p95_ms", "recall_at_10", "setup_s"}
    assert {m["name"] for m in cell.per_layer} == {
        *(f"{name}.b256" for name in ("api_host_ms", "api_prep_ms", "api_collect_ms", "search_span_ms",
                                      "search_host_gap_ms", "kernel_device_ms", "beam_hops", "device_idle")),
        "search_on_kernel.hamming", "kernel_roofline.hamming"}


def test_the_route_counter_reads_the_search_beam_spans_and_nothing_without_them():
    read = harness.metric_reader("search_on_kernel.hamming")
    call = SimpleNamespace(name="by_vectors")

    def ctx(fields):
        spans = [SimpleNamespace(name="search_beam", fields=f) for f in fields]
        return SimpleNamespace(program_spans=spans, calls=lambda: [call] * 2)

    assert read(ctx([{"on_kernel": 0}, {"on_kernel": 0}])) == 0.0
    assert read(ctx([{"on_kernel": 1}, {"on_kernel": 0}])) == 0.5
    with pytest.raises(NothingToRead):  # a program that records no such counter, as before it had one
        read(ctx([{}, {}]))


def test_the_cells_readers_on_the_spans_of_a_cpu_run():
    """A short window at a tiny size under the program's recorder: the
    readers of the program's spans read numbers, the route counter 0 (the
    host loop); with one made-up kernel of 1 ms in each call the roofline
    reads the plain walk's bytes over it."""
    from hannoy_tpu_torch.utils import tracing

    cell = harness.load_cell(CELL, sizes=TINY)
    data = harness.make_data(cell, 2**31 + 23, "cpu")
    with tempfile.TemporaryDirectory() as store:
        index = harness.build_index(cell, data, 23, store, "cpu", "raw")
        with tracing.record() as spans:
            w = harness.driver_of(cell).window(index, data, 0.3, True, 23)
        host = [ytrace.Interval(n, a + w.offset_ns, b + w.offset_ns) for n, a, b in w.spans]
        ctx = harness.TraceContext(cell, w, host, [], w.start_ns + w.offset_ns, w.end_ns + w.offset_ns,
                                   list(spans), index.reader._dev, data, 23)
        read = {k: v["value"] for k, v in harness.read_per_layer(cell, ctx).items()}
        assert set(read) == {"api_host_ms.b256", "api_prep_ms.b256", "api_collect_ms.b256", "search_span_ms.b256",
                             "search_host_gap_ms.b256", "beam_hops.b256", "search_on_kernel.hamming"}
        assert read["search_on_kernel.hamming"] == 0.0 and read["beam_hops.b256"] >= 1
        assert read["search_span_ms.b256"] > 0
        ctx.device = [ytrace.Interval("made_up_kernel", c.start, c.start + 1_000_000) for c in ctx.calls()]
        share = harness.metric_reader("kernel_roofline.hamming")(ctx)
        index = None
    assert 0 < share < 100
