"""search_span_ms.q1: the program's ``reader_search`` span per ``by_vector`` call (ms)."""

from annbench.yardstick import layers


def read(ctx):
    return layers.search_span_ms(ctx)
