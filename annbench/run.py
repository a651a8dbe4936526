"""Run one cell of the benchmark once, on this machine's card.

    python annbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The last line of standard output is one JSON
object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer metrics),
``device`` and, traced, ``breakdown``; ``setup_built_files``, the files
that the set-up built in the checkout (more than 0 in the run that compiled
the kernels, whose ``setup_s`` holds that); and last ``checks``: each number
that decided ``correct`` beside its limit. Those numbers are also the last
lines of standard error.

The run exits with another code than 0, printing no result, where no CUDA
card is present, and where the process holds JAX, its libraries or the JAX
package once the window has closed.
"""

from __future__ import annotations

import math
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
#: the program's and the libraries' kernel caches, each at a fixed path in the checkout
CACHE = ROOT / "_annbench_cache"
#: top-level module names that may not be loaded, compared whole
FORBIDDEN = ("jax", "jaxlib", "flax", "hannoy_tpu")


def process_start_s() -> float:
    """This process's start on ``time.time()``'s clock (from ``/proc``,
    to 10 ms), or now where ``/proc`` cannot say."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.time() - uptime + int(fields[19]) / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.time()


def forbidden_modules() -> list[str]:
    return sorted({name.split(".", 1)[0] for name in sys.modules} & set(FORBIDDEN))


def finite(x):
    """``x`` with every float that is not finite as None (JSON has no such numbers)."""
    if isinstance(x, dict):
        return {k: finite(v) for k, v in x.items()}
    if isinstance(x, list):
        return [finite(v) for v in x]
    if isinstance(x, float) and not math.isfinite(x):
        return None
    return x


def main(argv=None) -> int:
    import argparse

    start = process_start_s()
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda"), ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
        os.environ[var] = str(CACHE / sub)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    sys.path.insert(0, str(ROOT))

    import torch

    from annbench import harness

    need = harness.chips_of(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"annbench: {args.workload} needs {need} CUDA card(s); this machine has {count}", file=sys.stderr)
        return 2

    result = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace), process_start_s=start)

    found = forbidden_modules()
    if found:
        print(f"annbench: the process holds {', '.join(found)} after the window; no result", file=sys.stderr)
        return 3
    import json

    line = json.dumps(finite(result))
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
