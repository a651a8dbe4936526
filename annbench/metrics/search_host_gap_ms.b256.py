"""search_host_gap_ms.b256: the device's idle time inside the program's span
``reader_search``, per ``by_vectors`` call of 256 queries (ms): the host work
of the search's launches and of its one transfer that the card waits on."""

from annbench.yardstick import program


def read(ctx):
    return program.idle_ms_per_call(ctx, "reader_search")
