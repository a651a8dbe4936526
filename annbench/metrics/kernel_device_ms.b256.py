"""kernel_device_ms.b256: device time of every kernel that starts inside a
``by_vectors`` call of 256 queries, whatever its name (ms per call), from
the profiler."""

from annbench.yardstick import layers


def read(ctx):
    return layers.kernel_device_ms(ctx)
