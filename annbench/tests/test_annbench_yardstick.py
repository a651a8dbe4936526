"""The frozen yardstick: data, recall, statistics, the reference, the trace reduction."""

import json
import statistics

import numpy as np
import pytest
import torch

from annbench import reference
from annbench.yardstick import data, recall, stats, trace


def test_generator_is_deterministic_per_seed():
    big = 2**31 + 987_654_321  # more than 32 signed bits hold
    a = data.synthetic_hard(600, 24, 100, big, "cpu")
    b = data.synthetic_hard(600, 24, 100, big, "cpu")
    c = data.synthetic_hard(600, 24, 100, big + 1, "cpu")
    assert torch.equal(a.items, b.items) and torch.equal(a.queries, b.queries)
    assert not torch.equal(a.items, c.items)
    assert a.items.shape == (600, 24) and a.queries.shape == (100, 24)
    assert a.items.dtype == torch.float32 and torch.isfinite(a.items).all()


def test_generator_queries_are_not_items_and_mix_kinds():
    v = data.synthetic_hard(2000, 16, 200, 7, "cpu")
    d = torch.cdist(v.queries.double(), v.items.double())
    assert float(d.min()) > 0.0
    # out-of-topic queries lie farther from their nearest item than in-topic ones
    nearest = d.min(dim=1).values
    far = nearest > torch.quantile(nearest, 0.85)
    assert 5 <= int(far.sum()) <= 40


@pytest.mark.parametrize("case", ["tie_at_kth", "inside_eps", "beyond_eps", "missing"])
def test_tie_aware_recall(case):
    kth = torch.tensor([0.5], dtype=torch.float64)
    row = {
        "tie_at_kth": [0.1, 0.2, 0.5],
        "inside_eps": [0.1, 0.2, 0.5 + 0.5e-6],
        "beyond_eps": [0.1, 0.2, 0.5 + 2e-6],
        "missing": [0.1, 0.2, float("inf")],
    }[case]
    got = float(recall.recall_per_row(torch.tensor([row], dtype=torch.float64), kth, 3)[0])
    assert got == pytest.approx(1.0 if case in ("tie_at_kth", "inside_eps") else 2 / 3)


def test_p95_is_taken_over_every_sample():
    samples = [1.0] * 94 + [10.0] * 6
    assert stats.p95(samples) == pytest.approx(float(np.percentile(samples, 95)))
    assert stats.p95(samples) > 1.0  # the slow tail shows


def test_window_rate_counts_the_operation_that_overruns_the_window():
    # three updates of 1000 items; the window's length was 5 s, the last ended at 7 s
    assert stats.window_rate(3000, 0.0, 7.0) == pytest.approx(3000 / 7.0)
    with pytest.raises(ValueError):
        stats.window_rate(1, 2.0, 2.0)


def test_spread_is_the_quartile_distance_over_the_median():
    v = [10.0, 11.0, 12.0, 13.0, 14.0, 15.0]
    q1, _, q3 = statistics.quantiles(v, n=4)
    assert stats.spread(v) == pytest.approx((q3 - q1) / statistics.median(v))


def _np_cosine(q, x):
    q, x = q.astype(np.float64), x.astype(np.float64)
    den = np.linalg.norm(q, axis=1)[:, None] * np.linalg.norm(x, axis=1)[None, :]
    cos = np.clip(np.divide(q @ x.T, den, out=np.zeros_like(den), where=den > 1.1920929e-07), -1, 1)
    return np.where(den > 1.1920929e-07, (1 - cos) / 2, 0.0)


def test_reference_against_numpy():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((300, 12)).astype(np.float32)
    x[7] = 0.0  # a zero row: distance 0 by the crate's rule
    q = rng.standard_normal((20, 12)).astype(np.float32)
    want = _np_cosine(q, x)
    cos = reference.distance("cosine")
    got = reference.exact_topk(cos, torch.from_numpy(q), torch.from_numpy(x), 5, block=7)
    assert np.allclose(got.numpy(), np.sort(want, axis=1)[:, :5], rtol=0, atol=1e-12)
    qi = rng.integers(0, 20, size=50)
    xi = rng.integers(0, 300, size=50)
    d = reference.distances_of(cos, torch.from_numpy(q), torch.from_numpy(x), torch.from_numpy(qi),
                               torch.from_numpy(xi), block=16)
    assert np.allclose(d.numpy(), want[qi, xi], rtol=0, atol=1e-12)
    assert float(reference.distances_of(cos, torch.from_numpy(q), torch.from_numpy(x), torch.tensor([0]),
                                        torch.tensor([7]))[0]) == 0.0


def test_a_metric_without_a_plain_distance_is_refused():
    with pytest.raises(ValueError, match="no plain distance"):
        reference.distance("binary quantized cosine")
    with pytest.raises(ValueError, match="no plain distance"):
        reference.distance("euclidean")


def test_trace_busy_union_and_idle_by_host():
    iv = trace.Interval
    dev = [iv("void gather_staged_kernel<float, 1>(float const*)", 10, 20), iv("beam_search_kernel(BeamArgs)", 15, 30),
           iv("Memcpy DtoH (Device -> Pageable)", 60, 70)]
    assert trace.busy_ns(dev, 0, 100) == 30
    assert trace.busy_ns(dev, 12, 65) == 23
    host = [iv("by_vectors", 5, 40), iv("by_vectors", 50, 80)]
    gaps = dict(trace.idle_by_host(dev, host, 0, 100))
    assert gaps == pytest.approx({"by_vectors:head": 15e-9, "by_vectors:tail": 20e-9, "harness": 35e-9})
    assert trace.short_name(dev[0].name) == "gather_staged_kernel"
    ops = trace.top_ops(dev, 0, 100)
    assert ops[0] == ["beam_search_kernel", 15e-9]
    # every kernel that starts inside a call, whatever its name; copies are not kernels
    assert trace.kernel_time_in(dev, host) == 25
    assert trace.kernel_time_in(dev + [iv("some_new_kernel", 55, 58)], host) == 28
    assert trace.kernel_time_in(dev, [iv("x", 90, 95)]) == 0


def test_spreads_leave_the_compiling_run_out_of_setup(tmp_path, capsys):
    from annbench import spreads

    lines = []
    for i, (qps, setup, built) in enumerate([(100, 60.0, 3), (102, 40.0, 0), (98, 41.0, 0), (101, 39.0, 0)]):
        lines.append(json.dumps({"correct": True, "metrics": {"search_qps": {"value": qps, "unit": "queries/s"},
                                                              "setup_s": {"value": setup, "unit": "s"}},
                                 "setup_built_files": built}))
    f = tmp_path / "set1.jsonl"
    f.write_text("noise\n" + "\n".join(lines) + "\n")
    assert spreads.values_of(spreads.runs_of(str(f)), "setup_s") == [40.0, 41.0, 39.0]
    assert spreads.values_of(spreads.runs_of(str(f)), "search_qps") == [100, 102, 98, 101]
    assert spreads.main([str(f)]) == 0
    out = capsys.readouterr().out
    assert f"search_qps: n 4 median 100.5 spread {stats.spread([100, 102, 98, 101]):.4f}" in out
