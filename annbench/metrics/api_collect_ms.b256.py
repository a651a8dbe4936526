"""api_collect_ms.b256: the program's spans ``reader_collect`` and
``reader_top_up`` per ``by_vectors`` call of 256 queries (ms): the answers'
rows built on the host, and the degraded-search top-up."""

from annbench.yardstick import program


def read(ctx):
    return program.ms_per_call(ctx, "reader_collect", "reader_top_up")
