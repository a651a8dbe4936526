"""kernel_roofline.b256: the call's kernels' share of the search's roofline
(%): the least time of the rows a plain search of the same 256 queries on
the served graph reads, each once, at the configuration's row widths and
3.35 TB/s, over the device time of every kernel inside the call, on a
sample of the traced calls."""

from annbench.yardstick import layers


def read(ctx):
    return layers.kernel_roofline(ctx)
