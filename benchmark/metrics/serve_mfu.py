"""The model FLOPs of the served chunks' true lengths over the untraced
part of the window, against the card's bf16 peak (989 TFLOP/s)."""
from benchmark import costs


def read(rec):
    if "serve_rtfx" not in rec["e2e"] or rec["trace"] is None \
            or rec["untraced_s"] <= 0:
        return None
    flops = sum(costs.amt_forward_flops(rec["cfg"], n)
                for item in rec["untraced"] for batch in item["rows"]
                for n in batch if n > 0)
    return 100.0 * flops / rec["untraced_s"] / costs.PEAK_FLOPS["bf16"]
