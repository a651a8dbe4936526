"""search_span_ms.b256: the program's ``reader_search`` span per ``by_vectors``
call of 256 queries (ms): the search's launches and its one transfer to the
host."""

from annbench.yardstick import layers


def read(ctx):
    return layers.search_span_ms(ctx)
