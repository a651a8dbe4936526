"""api_host_ms.b256: the API's host work per ``by_vectors`` call of 256 queries
(ms): the call's wall time less the program's ``reader_search`` span."""

from annbench.yardstick import layers


def read(ctx):
    return layers.api_host_ms(ctx)
