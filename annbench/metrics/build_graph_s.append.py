"""build_graph_s.append: the program's span ``build_graph`` per update (s): the
plan, the upload, the insertion waves and the download, unfenced."""

from annbench.yardstick import program


def read(ctx):
    return program.ms_per_call(ctx, "build_graph") / 1e3
