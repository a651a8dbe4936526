"""update_items_per_s (items/s): the items appended in the window over the
seconds from the window's start to the end of its last update, which runs
across the end whole; an update ends when its probe search has returned."""

from annbench.yardstick import stats


def read(out):
    w = out.window
    return stats.window_rate(w.work, w.start_ns / 1e9, w.end_ns / 1e9)
