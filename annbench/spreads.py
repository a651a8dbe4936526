"""The spreads that the bounds of ``BENCHMARK.json`` are set from.

    python annbench/spreads.py SET_FILE [SET_FILE ...]

Each file holds one set of runs of one cell: the result lines that
``run.py`` printed, one JSON object a line (other lines are skipped). For
each end-to-end metric and set it prints the median, the spread
(``yardstick.stats.spread``: the quartile distance over the median), the
spread with the run farthest from the median left out, and the range. A run
whose set-up built files in the checkout (``setup_built_files`` > 0: it
compiled the kernels) is left out of ``setup_s``, whose first run is
recorded apart. Last it prints, per metric, the widest spread over the sets
and five times it, the bound that it suggests (never under 1%).
"""

from __future__ import annotations

import json
import statistics
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from annbench.yardstick import stats  # noqa: E402


def runs_of(path: str) -> list[dict]:
    out = []
    for line in Path(path).read_text().splitlines():
        line = line.strip()
        if line.startswith("{") and '"metrics"' in line:
            out.append(json.loads(line))
    return out


def values_of(runs: list[dict], name: str) -> list[float]:
    keep = [r for r in runs if name != "setup_s" or not r.get("setup_built_files")]
    return [r["metrics"][name]["value"] for r in keep if name in r.get("metrics", {})]


def without_farthest(values: list[float]) -> list[float]:
    med = statistics.median(values)
    far = max(range(len(values)), key=lambda i: abs(values[i] - med))
    return values[:far] + values[far + 1 :]


def main(argv: list[str]) -> int:
    if not argv:
        print(__doc__)
        return 2
    widest: dict[str, float] = {}
    for path in argv:
        runs = runs_of(path)
        print(f"{path}: {len(runs)} runs, correct {[r['correct'] for r in runs]}")
        names = sorted({n for r in runs for n in r.get("metrics", {})})
        for name in names:
            v = values_of(runs, name)
            if len(v) < 3:
                print(f"  {name}: {len(v)} runs, too few for a spread")
                continue
            sp = stats.spread(v)
            sp_trim = stats.spread(without_farthest(v))
            widest[name] = max(widest.get(name, 0.0), sp)
            print(f"  {name}: n {len(v)} median {statistics.median(v)!r} spread {sp:.4f} "
                  f"(farthest left out {sp_trim:.4f}) range {min(v)!r} .. {max(v)!r}")
    print("widest spread, and 5x it (at least 0.01):")
    for name, sp in sorted(widest.items()):
        print(f"  {name}: {sp:.4f} -> {max(0.01, 5 * sp):.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
