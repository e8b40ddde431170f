"""``readers.idle_pct`` in the cells that report ``train_rtfx``."""
from benchmark import readers


def read(rec):
    return readers.idle_pct(rec, "train_rtfx")
