"""search_host_gap_ms.q1: the device's idle time inside the program's span
``reader_search``, per ``by_vector`` call (ms): the host work of the search's
launches and of its one transfer that the card waits on."""

from annbench.yardstick import program


def read(ctx):
    return program.idle_ms_per_call(ctx, "reader_search")
