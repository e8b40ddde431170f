"""``readers.train_mfu`` in the cells that report ``train_rtfx``."""
from benchmark import readers


def read(rec):
    return readers.train_mfu(rec, "train_rtfx")
