"""build_upload_s.append: the program's span ``build_upload`` per update (s): the
whole graph's ``hnsw.to_device`` at the start of ``build_graph``."""

from annbench.yardstick import program


def read(ctx):
    return program.ms_per_call(ctx, "build_upload") / 1e3
