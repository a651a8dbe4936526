"""beam_hops.b256: the layer-0 beam's hops per ``by_vectors`` call of 256 queries:
field ``hops`` of the program's span ``reader_search``, the hop count of the
call's slowest query, which sets the batch kernel's time."""

from annbench.yardstick import program


def read(ctx):
    return program.field_per_call(ctx, "reader_search", "hops")
