"""build_waves.append: insertion waves per update: field ``waves`` of the
program's span ``build_graph`` (the build's ``BuildStats.waves``)."""

from annbench.yardstick import program


def read(ctx):
    return program.field_per_call(ctx, "build_graph", "waves")
