"""The comparison that decides ``correct`` fails where it must: the control
(the program's bfloat16 tier) and each planted fault, at a tiny size on the
CPU, with the cells' own limits; a sound run passes."""

import json

import pytest

from annbench import controls, harness

from conftest import ROOT, TINY

CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]
CASES = [(cell, fault) for cell in CELLS for fault, (_, kinds) in controls.FAULTS.items()
         if harness.load_cell(cell).mix["kind"] in kinds]


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    r = controls.run_variant(cell, 11, 0.5, "sound", device="cpu", sizes=TINY)
    assert r["correct"], r["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_control_in_bfloat16_is_not_correct(cell):
    r = controls.run_variant(cell, 12, 0.5, "bf16", device="cpu", sizes=TINY)
    assert not r["correct"]
    assert r["checks"]["dist_gap"]["value"] > r["checks"]["dist_gap"]["limit"]


@pytest.mark.parametrize("cell,fault", CASES)
def test_planted_fault_is_not_correct(cell, fault):
    r = controls.run_variant(cell, 13, 0.5, fault, device="cpu", sizes=TINY)
    assert not r["correct"], (fault, r["checks"])
