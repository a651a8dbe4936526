"""The readings that the limits of ``correct`` are set from: sound runs, the control, planted faults.

    python annbench/controls.py --workload <name> --seeds 11,12,13 --seconds 5 \\
        --variants sound,bf16,beam_stops,rows_dropped,answer_altered

runs the cell once per seed and variant in one process and prints, per run,
one JSON line of the numbers compared and whether the run came out correct:

* ``sound``: the program as the configuration states it;
* ``bf16``: the control, the program with its own lower-precision path on,
  ``Database(tier="bf16")`` (rows held and compared in bfloat16, one step
  below the configuration's float32);
* a fault planted under the timed path (``FAULTS``), for the cells whose
  traffic can have it.

The benchmark's own runs never run this. The tests in ``tests/`` run it at a
tiny size on the CPU; on the card it runs at the cell's own size.
"""

from __future__ import annotations

import contextlib
import sys
from pathlib import Path


@contextlib.contextmanager
def _patched(owner, name: str, make):
    orig = getattr(owner, name)
    setattr(owner, name, make(orig))
    try:
        yield
    finally:
        setattr(owner, name, orig)


def beam_stops():
    """A step that returns its state unchanged: after its first hop the
    layer-0 beam leaves its pool as it is (the search's iteration cap at 1)."""
    from hannoy_tpu_torch.ops import beam

    def make(orig):
        def hnsw_search(g, q, qn, ef, max_iters=None, ef_upper=1, cancel=None):
            return orig(g, q, qn, ef, max_iters=1, ef_upper=ef_upper, cancel=cancel)

        return hnsw_search

    return _patched(beam, "hnsw_search", make)


def rows_dropped():
    """Half of the batch left out: a search answers the first half of its
    queries and returns empty rows for the rest (a batch of one: every
    other call)."""
    from hannoy_tpu_torch.api import Reader, Searched

    calls = [0]

    def make(orig):
        def _nns_by_vecs(self, opt, vectors, cancel=None):
            vectors = vectors.reshape(-1, vectors.shape[-1])
            calls[0] += 1
            keep = vectors.shape[0] // 2 if vectors.shape[0] > 1 else calls[0] % 2
            head = orig(self, opt, vectors[:keep], cancel) if keep else []
            return head + [Searched([], False) for _ in range(vectors.shape[0] - keep)]

        return _nns_by_vecs

    return _patched(Reader, "_nns_by_vecs", make)


def answer_altered():
    """An answer altered where it is produced: each row's first item is
    replaced by the next slot's item, its distance kept."""
    from hannoy_tpu_torch.api import Reader

    def make(orig):
        def _collect(self, slots, dists, count):
            slots = slots.copy()
            ok = slots[:, 0] >= 0
            slots[ok, 0] = (slots[ok, 0] + 1) % self._graph.ids.shape[0]
            return orig(self, slots, dists, count)

        return _collect

    return _patched(Reader, "_collect", make)


def build_unchanged():
    """A step that returns its state unchanged: an update's device build
    returns at once, leaving the graph as it was; the new items are stored,
    and their rows flushed, but linked to nothing."""
    import numpy as np

    from hannoy_tpu_torch.build import builder

    def make(orig):
        def build_graph(g, insert_slots, delete_slots, opts, stats, **kw):
            stats.touched = np.asarray(insert_slots, dtype=np.int64)

        return build_graph

    return _patched(builder, "build_graph", make)


#: faults by name → (planter, the mix kinds whose traffic can have it)
FAULTS = {
    "beam_stops": (beam_stops, ("search", "append")),
    "rows_dropped": (rows_dropped, ("search", "append")),
    "answer_altered": (answer_altered, ("search", "append")),
    "build_unchanged": (build_unchanged, ("append",)),
}


def run_variant(workload: str, seed: int, seconds: float, variant: str, device="cuda", sizes=None) -> dict:
    from annbench import harness

    if variant == "sound":
        return harness.run_cell(workload, seed, seconds, False, device=device, sizes=sizes)
    if variant == "bf16":
        return harness.run_cell(workload, seed, seconds, False, device=device, sizes=sizes, tier="bf16")
    return harness.run_cell(workload, seed, seconds, False, device=device, sizes=sizes, plant=FAULTS[variant][0])


def main(argv=None) -> int:
    import argparse
    import json

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--variants", default="sound,bf16")
    args = ap.parse_args(argv)
    for seed in [int(s) for s in args.seeds.split(",")]:
        for variant in args.variants.split(","):
            r = run_variant(args.workload, seed, args.seconds, variant)
            row = {"workload": args.workload, "seed": seed, "variant": variant, "correct": r["correct"],
                   "failed": r["failed"], "attempted": r["attempted"],
                   "numbers": {k: c["value"] for k, c in r["checks"].items()}, "kind": r["device"]["kind"],
                   "power_limit_w": r["device"].get("power_limit_w")}
            print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
