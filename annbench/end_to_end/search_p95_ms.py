"""search_p95_ms (ms): the 95th percentile of the wall time of every search
call in the window, from the call to its Python result."""

from annbench.yardstick import stats


def read(out):
    return stats.p95(out.window.durations) * 1e3
