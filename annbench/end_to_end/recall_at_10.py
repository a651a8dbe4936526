"""recall_at_10 (fraction): the mean tie-aware recall@10 of the answers
judged after the window, each returned item's distance recomputed by the
plain reference; in the append traffic, over the items live at each probe."""


def read(out):
    return out.recall
