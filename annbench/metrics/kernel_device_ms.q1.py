"""kernel_device_ms.q1: device time of every kernel that starts inside a
``by_vector`` call, whatever its name (ms per call), from the profiler."""

from annbench.yardstick import layers


def read(ctx):
    return layers.kernel_device_ms(ctx)
