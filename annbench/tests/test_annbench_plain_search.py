"""The plain search behind ``kernel_roofline``'s byte count, on a graph the
program built; and one tiny run on the card where there is one."""

import tempfile

import pytest

from annbench import harness
from annbench.yardstick import plain_search

from conftest import TINY


def test_plain_search_reads_a_bounded_set_of_live_rows():
    cell = harness.load_cell("wiki-485k.search-b256", sizes=TINY)
    data = harness.make_data(cell, 21, "cpu")
    with tempfile.TemporaryDirectory() as store:
        index = harness.build_index(cell, data, 21, store, "cpu", "raw")
        g = index.reader._dev
        q = data.queries[:64]
        rows = plain_search.rows_read(g, q, 50)
        one = plain_search.rows_read(g, q[:1], 50)
    n = TINY["n_items"]
    assert 0 < one.store_rows <= rows.store_rows <= n
    assert 0 < rows.link0_rows <= rows.store_rows
    assert rows.bytes(32, 32, 16, 64) > one.bytes(32, 32, 16, 1) > 0


def test_plain_search_follows_the_beam_rule():
    assert plain_search.ef_upper_of(485_859, 50) == 8
    assert plain_search.ef_upper_of(1_000_000, 50) == 32
    assert plain_search.ef_upper_of(10_000, 50) == 1


@pytest.mark.cuda
def test_tiny_run_on_the_card(cuda_device):
    r = harness.run_cell("wiki-485k.search-b256", 31, 1.0, True, device=cuda_device, sizes=TINY)
    assert r["correct"], r["checks"]
    assert r["device"]["busy_s"] > 0

