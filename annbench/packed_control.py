"""The control of a packed cell: its answers' distances in bfloat16.

    python annbench/packed_control.py --workload ada002-hamming-999k.search-b256 \\
        --seeds 11,12,13 --seconds 5

``controls.py``'s control is the program's own bfloat16 tier, and packed
rows have none: ``Database(tier="bf16")`` holds a packed metric's lanes as
they are, so on a packed cell that control is the sound run. A bit code has
no narrower row, so the step below the configuration's precision is taken
where the precision is, at the distances: the program computes a packed
distance as a float32 ratio (``popcount / padded_bits``), and this control
returns each answer's distances rounded to bfloat16 (8 bits of significand
against float32's 24), ids and order kept. It is planted where the answers
are produced (``Reader._collect``) and judged by the harness's own
comparison, as the planted faults are. It fails ``dist_gap`` alone: recall
is read by the reference's distances, and the rounding keeps each row
ascending.

It prints one JSON line a run, as ``controls.py`` does. The benchmark's own
runs never run this.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

VARIANT = "dists_bf16"


def dists_bf16():
    """The answers' distances rounded to bfloat16 where they are produced."""
    import numpy as np
    import torch

    from annbench.controls import _patched
    from hannoy_tpu_torch.api import Reader

    def make(orig):
        def _collect(self, slots, dists, count):
            rounded = torch.from_numpy(np.ascontiguousarray(dists)).to(torch.bfloat16).float().numpy()
            return orig(self, slots, rounded, count)

        return _collect

    return _patched(Reader, "_collect", make)


def run(workload: str, seed: int, seconds: float, device="cuda", sizes=None) -> dict:
    from annbench import harness

    return harness.run_cell(workload, seed, seconds, False, device=device, sizes=sizes, plant=dists_bf16)


def main(argv=None) -> int:
    import argparse

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, default=5.0)
    args = ap.parse_args(argv)
    for seed in [int(s) for s in args.seeds.split(",")]:
        r = run(args.workload, seed, args.seconds)
        row = {"workload": args.workload, "seed": seed, "variant": VARIANT, "correct": r["correct"],
               "failed": r["failed"], "attempted": r["attempted"],
               "numbers": {k: c["value"] for k, c in r["checks"].items()}, "kind": r["device"]["kind"],
               "power_limit_w": r["device"].get("power_limit_w")}
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
