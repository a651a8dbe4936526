"""api_host_ms.q1: the API's host work per ``by_vector`` call (ms): the call's
wall time less the program's ``reader_search`` span."""

from annbench.yardstick import layers


def read(ctx):
    return layers.api_host_ms(ctx)
