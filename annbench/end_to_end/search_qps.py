"""search_qps (queries/s): every query answered in the window over the
seconds from the window's start to the end of its last call, which runs
across the end whole."""

from annbench.yardstick import stats


def read(out):
    w = out.window
    return stats.window_rate(w.work, w.start_ns / 1e9, w.end_ns / 1e9)
