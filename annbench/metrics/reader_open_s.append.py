"""reader_open_s.append: the benchmark's span around ``Reader.open`` (the graph
from the commit's cache, its upload to the device), ended by
``torch.cuda.synchronize()``, mean per update (s)."""

from annbench.yardstick import layers


def read(ctx):
    return layers.stage_s(ctx, "reader_open")
