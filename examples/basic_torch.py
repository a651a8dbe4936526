"""End-to-end example on the PyTorch port: add → build → search.

The counterpart of ``examples/basic.py`` against ``hannoy_tpu_torch``:
create a database, insert a handful of vectors inside a writer
transaction, build, then query. The index is built and served on
``--device`` (a CUDA card unless told otherwise), under ``--metric`` (any
of the seven: cosine, euclidean, manhattan, hamming, bq_cosine,
bq_euclidean, bq_manhattan; the packed ones keep one bit per dimension)
and, for an f32 metric, with its rows held on the device in ``--tier``
(raw f32, bf16 or int8; the files on disk do not depend on it).

Run: python examples/basic_torch.py [--device cuda|cpu] [--metric cosine] [--tier raw|bf16|int8]
"""

import argparse
import os
import sys
import tempfile

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from hannoy_tpu_torch import Database, Metric


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda", help="torch device to build and serve on")
    parser.add_argument("--metric", default="cosine", choices=[m.value for m in Metric])
    parser.add_argument("--tier", default="raw", choices=["raw", "bf16", "int8"], help="device storage tier")
    args = parser.parse_args()

    rng = np.random.default_rng(42)
    dims, n = 64, 1000
    vectors = rng.standard_normal((n, dims)).astype(np.float32)

    with tempfile.TemporaryDirectory() as path:
        db = Database(path, Metric(args.metric), device=args.device, tier=args.tier)

        # the writer context manager builds the HNSW graph and commits on exit
        with db.writer(dimensions=dims, m=16, ef=100) as writer:
            writer.add_items(range(n), vectors)

        reader = db.reader()
        query = vectors[123]
        for item_id, dist in reader.by_vec(query, n=5, ef_search=100):
            print(f"item {item_id:4d}  distance {dist:.4f}")

        # batched search is the throughput path: one search on the device
        batch = reader.by_vecs(vectors[:32], n=3)
        hits = sum(1 for i, row in enumerate(batch) if row and row[0][0] == i)
        print(f"batched self-search: {hits}/32 exact hits")  # packed metrics tie: equal codes share distance 0
        db.close()


if __name__ == "__main__":
    main()
