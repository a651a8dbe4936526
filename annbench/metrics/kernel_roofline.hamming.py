"""kernel_roofline.hamming: the call's kernels' share of the packed search's
roofline (%): the least time of the rows a plain packed search of the same
256 queries on the served graph reads (``plain_packed``), each once, at the
configuration's widths and 3.35 TB/s, over the device time of every kernel
inside the call, on a sample of the traced calls."""

from annbench import plain_packed


def read(ctx):
    return plain_packed.kernel_roofline(ctx)
