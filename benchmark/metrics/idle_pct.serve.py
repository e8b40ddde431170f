"""``readers.idle_pct`` in the cells that report ``serve_rtfx``."""
from benchmark import readers


def read(rec):
    return readers.idle_pct(rec, "serve_rtfx")
