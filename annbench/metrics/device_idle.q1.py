"""device_idle.q1: the share of the traced window in which no operation ran on the device (%)."""

from annbench.yardstick import layers


def read(ctx):
    return layers.device_idle(ctx)
