"""BENCHMARK.json against the benchmark's contract, and cells found by name."""

import json
import re
import shutil

import pytest

from annbench import harness

from conftest import ROOT, TINY

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


def test_top_level_keys_and_paths():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["annbench"]
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert len(BENCH["command"]) <= 32 and all(1 <= len(w) <= 200 for w in BENCH["command"])
    assert (ROOT / BENCH["command"][1]).is_file()
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_lines():
    named = BENCH["configs"] + BENCH["workloads"] + BENCH["end_to_end"] + BENCH["per_layer"]
    for entry in named:
        assert NAME.match(entry["name"]), entry["name"]
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in BENCH[group]]
        assert len(names) == len(set(names))
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for text in [w["why"] for w in BENCH["workloads"]] + [m["layer"] for m in BENCH["per_layer"]] + \
            [c["source"] for c in BENCH["configs"]] + [c["why"] for c in BENCH["configs"]]:
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_entries_have_just_the_contract_keys():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("annbench/") and (ROOT / c["file"]).is_file()
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["reduced"] == c["reduced"] == [] and cfg["source"] == c["source"]
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")


def test_every_cell_reports_setup_another_end_to_end_and_a_layer():
    for w in BENCH["workloads"]:
        cell = harness.load_cell(w["name"])
        e2e = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert cell.per_layer
        for m in cell.per_layer:
            assert m["moves"] in e2e, (w["name"], m["name"])
            assert (ROOT / "annbench" / "metrics" / f"{m['name']}.py").is_file()


def test_each_layer_name_is_one_line_and_shared_letter_for_letter():
    by_prefix = {}
    for m in BENCH["per_layer"]:
        by_prefix.setdefault(m["name"].split(".")[0], set()).add(m["layer"])
    assert all(len(layers) == 1 for layers in by_prefix.values())


def test_an_added_cell_needs_only_files(tmp_path):
    """A later change adds a configuration, a mix, limits and a metric as new
    files and entries; the harness finds them by name with no edit."""
    root = tmp_path / "checkout"
    shutil.copytree(ROOT / "annbench", root / "annbench", ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cfg = json.loads((ROOT / "annbench/configs/wiki-485k.json").read_text())
    cfg.update(name="wiki-100k", n_items=100_000)
    (root / "annbench/configs/wiki-100k.json").write_text(json.dumps(cfg))
    (root / "annbench/mixes/search-b64.json").write_text(json.dumps({"kind": "search", "batch": 64, "warmup_calls": 2}))
    (root / "annbench/limits/wiki-100k.search-b64.json").write_text(
        (ROOT / "annbench/limits/wiki-485k.search-b256.json").read_text())
    (root / "annbench/metrics/calls.b64.py").write_text("def read(ctx):\n    return len(ctx.calls())\n")
    bench["configs"].append({"name": "wiki-100k", "source": "x", "file": "annbench/configs/wiki-100k.json",
                             "reduced": ["n_items"], "why": "x"})
    bench["workloads"].append({"name": "wiki-100k.search-b64", "config": "wiki-100k", "traffic": "search-b64",
                               "chips": 1, "why": "x"})
    bench["per_layer"].append({"name": "calls.b64", "unit": "calls", "better": "higher", "source": "host_clock",
                               "layer": "api", "moves": "search_qps", "workloads": ["wiki-100k.search-b64"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = harness.load_cell("wiki-100k.search-b64", root=root)
    assert cell.config["n_items"] == 100_000 and cell.mix["batch"] == 64
    assert [m["name"] for m in cell.per_layer] == ["calls.b64"]
    assert harness.driver_of(cell).batch == 64


def test_a_new_kind_metric_generator_and_distance_need_only_files(tmp_path):
    """A later change adds a kind of traffic, an end-to-end metric, a data
    generator and a configuration of another metric as new files; a run of
    the new cell finds each by its name and edits no file that is there."""
    root = tmp_path / "checkout"
    shutil.copytree(ROOT / "annbench", root / "annbench", ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cfg = json.loads((ROOT / "annbench/configs/wiki-485k.json").read_text())
    cfg.update(name="gauss-l2", metric="euclidean", data={"generator": "gauss", "scale": 0.5}, **TINY)
    (root / "annbench/configs/gauss-l2.json").write_text(json.dumps(cfg))
    (root / "annbench/generators/gauss.py").write_text(
        "import torch\n"
        "def make(n, d, q, seed, device, scale):\n"
        "    g = torch.Generator(device=device); g.manual_seed(seed)\n"
        "    return (scale * torch.randn(n, d, generator=g, device=device),\n"
        "            scale * torch.randn(q, d, generator=g, device=device))\n")
    (root / "annbench/distances/euclidean.py").write_text(
        "def pairwise(q, x):\n"
        "    return ((q[:, None, :] - x[None, :, :]) ** 2).sum(dim=2)\n"
        "def rowwise(q, x):\n"
        "    return ((q - x) ** 2).sum(dim=1)\n")
    (root / "annbench/drivers/twice.py").write_text(
        "from annbench.drivers import search\n"
        "class Driver(search.Driver):\n"
        "    def call(self, reader, data, start):\n"
        "        super().call(reader, data, start)\n"
        "        return super().call(reader, data, start)\n")
    (root / "annbench/mixes/twice-b64.json").write_text(json.dumps({"kind": "twice", "batch": 64, "warmup_calls": 1}))
    (root / "annbench/end_to_end/calls_per_s.py").write_text(
        "def read(out):\n"
        "    w = out.window\n"
        "    return len(w.durations) / ((w.end_ns - w.start_ns) / 1e9)\n")
    (root / "annbench/limits/gauss-l2.twice-b64.json").write_text(
        json.dumps({"dist_gap": {"limit": 1e-4}, "bad_rows": {"limit": 0}, "miss_share": {"limit": 0.25}}))
    bench["configs"].append({"name": "gauss-l2", "source": "x", "file": "annbench/configs/gauss-l2.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "gauss-l2.twice-b64", "config": "gauss-l2", "traffic": "twice-b64",
                               "chips": 1, "why": "x"})
    bench["end_to_end"].append({"name": "calls_per_s", "unit": "calls/s", "better": "higher", "bound": 0.1,
                                "source": "host_clock", "workloads": ["gauss-l2.twice-b64"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    r = harness.run_cell("gauss-l2.twice-b64", 9, 0.3, False, device="cpu", root=root)
    assert r["correct"], r["checks"]
    assert r["metrics"]["calls_per_s"]["value"] > 0 and r["checks"]["dist_gap"]["value"] < 1e-4
    assert set(r["metrics"]) == {"calls_per_s", "recall_at_10", "setup_s"}


def test_an_unknown_cell_is_refused():
    with pytest.raises(SystemExit):
        harness.load_cell("no-such.cell")
