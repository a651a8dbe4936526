"""search_on_kernel.hamming: the share of ``by_vectors`` calls whose layer-0
beam ran on the search kernel: field ``on_kernel`` of the program's span
``search_beam`` (1 the kernel, 0 the host loop), summed over the calls."""

from annbench.yardstick import program


def read(ctx):
    return program.field_per_call(ctx, "search_beam", "on_kernel")
