"""The 95th percentile of the request latencies (call to notes, host
clock) of the window's untraced requests, in the cells that report
``serve_rtfx``. The closed loop runs at the system's capacity, so the tail
is each request's own service time; it spreads too much from run to run
to carry a bound (``PERF.md``)."""
import numpy as np


def read(rec):
    if "serve_rtfx" not in rec["e2e"] or rec["trace"] is None:
        return None
    return float(np.percentile([w["latency_ms"] for w in rec["untraced"]],
                               95))
