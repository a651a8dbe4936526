"""One run end to end at a tiny size on the CPU: the result's line, the
window's accounting, the import rule, and the refusal without a card."""

import ast
import json
import os
import subprocess
import sys
import tempfile

import pytest
import torch

from annbench import harness, run

from conftest import ROOT, TINY

SEED = 2**31 + 4242


@pytest.fixture(scope="module")
def results():
    """One untraced run of each cell."""
    out = {}
    for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]:
        out[w["name"]] = harness.run_cell(w["name"], SEED, 1.0, False, device="cpu", sizes=TINY)
    return out


def test_result_line_schema(results):
    for name, r in results.items():
        assert list(r)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
        assert list(r)[-1] == "checks", "the numbers compared come last"
        assert r["correct"] is True, (name, r["checks"])
        assert r["attempted"] > 0 and r["failed"] == 0
        cell = harness.load_cell(name)
        assert set(r["metrics"]) == {m["name"] for m in cell.end_to_end}
        for m in cell.end_to_end:
            assert r["metrics"][m["name"]]["unit"] == m["unit"]
            assert r["metrics"][m["name"]]["value"] > 0
        assert set(r["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
        for c in r["checks"].values():
            assert set(c) == {"value", "limit"}
        json.loads(json.dumps(run.finite(r), allow_nan=False))


def test_finite_replaces_what_json_cannot_hold():
    assert run.finite({"a": [float("inf"), 1.0], "b": float("nan")}) == {"a": [None, 1.0], "b": None}


def test_append_rate_runs_to_the_end_of_the_update_that_overruns_the_window():
    cell = harness.load_cell("dbpedia-100k.append", sizes=TINY)
    data = harness.make_data(cell, 5, "cpu")
    with tempfile.TemporaryDirectory() as store:
        index = harness.build_index(cell, data, 5, store, "cpu", "raw")
        driver = harness.driver_of(cell)
        w = driver.window(index, data, 1e-3, False, 5)
        extra = driver.after_window(index, data, w, 5)
    assert w.work == cell.mix["update_items"] and len(w.durations) == 1
    assert w.end_ns - w.start_ns >= int(w.durations[0] * 1e9)  # the window runs to the update's end
    rate = harness.module(cell.home, "end_to_end", "update_items_per_s").read(harness.Outcome(cell, w, 1.0))
    assert rate == pytest.approx(w.work / ((w.end_ns - w.start_ns) / 1e9))
    assert extra == {"store_mismatch": 0}


def _search_window(seconds, seed=6, batch=None):
    cell = harness.load_cell("wiki-485k.search-b256", sizes=TINY)
    if batch is not None:
        cell.mix["batch"] = batch
    data = harness.make_data(cell, seed, "cpu")
    with tempfile.TemporaryDirectory() as store:
        index = harness.build_index(cell, data, seed, store, "cpu", "raw")
        w = harness.driver_of(cell).window(index, data, seconds, False, seed)
    return cell, w


def test_search_rate_and_tail_are_taken_over_every_call():
    cell, w = _search_window(0.5)
    calls = len(w.durations)
    assert calls >= 1 and w.work == calls * 256 and len(w.call_starts) == calls
    out = harness.Outcome(cell, w, 1.0)
    p95 = harness.module(cell.home, "end_to_end", "search_p95_ms").read(out)
    qps = harness.module(cell.home, "end_to_end", "search_qps").read(out)
    assert p95 >= 1e3 * sorted(w.durations)[int(0.9 * (calls - 1))]
    assert qps == pytest.approx(w.work / ((w.end_ns - w.start_ns) / 1e9))


def test_search_judges_the_first_pass_and_a_share_of_later_calls(monkeypatch):
    cell = harness.load_cell("wiki-485k.search-b256")
    monkeypatch.setattr(harness.module(cell.home, "drivers", "search"), "JUDGE_SHARE", 0.5)
    cell, w = _search_window(2.0, batch=32)
    first_pass = -(-TINY["query_pool"] // 32)
    calls = len(w.durations)
    kept = len(w.results)
    assert calls > first_pass + 4, calls
    assert first_pass < kept < calls
    ans = harness.collect(w, 10)
    assert ans.ids.shape == (kept * 32, 10) and (ans.ids >= 0).all()
    # the first pass holds every pool query once, in order
    assert (ans.source[: TINY["query_pool"]] == list(range(TINY["query_pool"]))).all()
    # the same seed keeps the same calls
    _, again = _search_window(2.0, batch=32)
    a, b = [s[0][0] for s in w.sources], [s[0][0] for s in again.sources]
    n = min(len(a), len(b))
    assert n > first_pass and a[:n] == b[:n]


def test_run_refuses_without_a_card():
    p = subprocess.run([sys.executable, "annbench/run.py", "--workload", "wiki-485k.search-b256", "--seed", "1",
                        "--seconds", "1", "--trace", "0"], cwd=ROOT, capture_output=True, text=True, timeout=300)
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    assert p.returncode != 0 and p.stdout.strip() == ""
    assert "needs 1 CUDA card" in p.stderr


def test_forbidden_modules_compare_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "hannoy_tpu_torch_like", sys)
    assert "hannoy_tpu" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "hannoy_tpu.api", sys)
    assert "hannoy_tpu" in run.forbidden_modules()


def _imports(path):
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_no_run_path_module_imports_jax_or_the_jax_package():
    for path in (ROOT / "annbench").rglob("*.py"):
        assert not _imports(path) & {"jax", "jaxlib", "flax", "hannoy_tpu"}, path


def test_reference_and_yardstick_import_nothing_of_the_program():
    for path in [ROOT / "annbench/reference.py", ROOT / "annbench/spreads.py",
                 *(ROOT / "annbench/yardstick").glob("*.py"), *(ROOT / "annbench/distances").glob("*.py"),
                 *(ROOT / "annbench/generators").glob("*.py"), *(ROOT / "annbench/end_to_end").glob("*.py")]:
        assert "hannoy_tpu_torch" not in _imports(path), path


def test_a_run_loads_no_jax(tmp_path):
    code = ("import sys; sys.path.insert(0, %r)\n"
            "from annbench import harness, run\n"
            "harness.run_cell('wiki-485k.search-q1', 3, 0.2, False, device='cpu', sizes=%r)\n"
            "print(run.forbidden_modules())") % (str(ROOT), TINY)
    env = {**os.environ, "OMP_NUM_THREADS": "2"}
    p = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=600, cwd=tmp_path, env=env)
    assert p.returncode == 0, p.stderr[-2000:]
    assert p.stdout.strip().splitlines()[-1] == "[]"
