"""build_prologue_s.append: the program's span ``build_prologue`` per update (s):
the Writer's journal, the graph from the cache or the store (``load_graph`` and
its children), the staging of the new items."""

from annbench.yardstick import program


def read(ctx):
    return program.ms_per_call(ctx, "build_prologue") / 1e3
