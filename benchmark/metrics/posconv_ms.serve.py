"""Device milliseconds a batch of the kernels launched inside the
transcriber's positional-embedding module (the span ``bench.posconv``,
opened and closed by forward hooks on the module instance it runs)."""
from benchmark import trace


def read(rec):
    if "serve_rtfx" not in rec["e2e"] or rec["trace"] is None:
        return None
    calls = sum(name == "bench.posconv" for name, _, _ in rec["trace"]["spans"])
    kernels = trace.launched_in(rec["trace"], "bench.posconv")
    if not calls or not kernels:
        return None
    return sum(e - s for _, s, e, _ in kernels) / 1e6 / calls
