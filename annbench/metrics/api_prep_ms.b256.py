"""api_prep_ms.b256: the program's span ``reader_prep`` per ``by_vectors`` call of
256 queries (ms): the dimension check, the queries' packing and norms on the
host, and their two uploads."""

from annbench.yardstick import program


def read(ctx):
    return program.ms_per_call(ctx, "reader_prep")
