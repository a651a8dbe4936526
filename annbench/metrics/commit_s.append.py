"""commit_s.append: the benchmark's span around ``Database.commit_rw_txn()``, mean per update (s)."""

from annbench.yardstick import layers


def read(ctx):
    return layers.stage_s(ctx, "commit")
