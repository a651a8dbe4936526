"""build_s.append: the benchmark's span around ``Writer.build()``, ended by
``torch.cuda.synchronize()``, mean per update (s)."""

from annbench.yardstick import layers


def read(ctx):
    return layers.stage_s(ctx, "build")
