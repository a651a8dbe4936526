"""commit_log_s.append: the store's log write per update (s): field ``log_ns`` of
the program's span ``store_commit`` (the batch's write, flush and fsync, timed
inside the native engine's commit)."""

from annbench.yardstick import program


def read(ctx):
    return program.field_per_call(ctx, "store_commit", "log_ns") / 1e9
