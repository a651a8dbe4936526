"""build_graph_reused.append: builds per update that started from a graph
held in memory, here a fork of the one the last commit left: field
``graph_reused`` of the program's span ``build_prologue`` (1 such a build, 0
one that loaded the graph from the store or started empty)."""

from annbench.yardstick import program


def read(ctx):
    return program.field_per_call(ctx, "build_prologue", "graph_reused")
