"""commit_publish_s.append: the store's publish per update (s): field
``publish_ns`` of the program's span ``store_commit`` (the copy of the
committed tables, the batch's merge and the generation's swap, timed inside the
native engine's commit)."""

from annbench.yardstick import program


def read(ctx):
    return program.field_per_call(ctx, "store_commit", "publish_ns") / 1e9
