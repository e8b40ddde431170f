"""``readers.loader_wait_pct`` in the cells that report ``train_rtfx``."""
from benchmark import readers


def read(rec):
    return readers.loader_wait_pct(rec, "train_rtfx")
