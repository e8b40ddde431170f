"""What the per-layer metric readers share: each ``metrics/<name>.py``
reads its number through one of these, for the cells that report the
end-to-end metric it moves (``rec["e2e"]``)."""
from __future__ import annotations

from benchmark import costs


def idle_pct(rec, moves):
    """The traced window's share in which no kernel, copy or set ran on
    the device: one minus the union of device intervals."""
    t = rec["trace"]
    if moves not in rec["e2e"] or t is None or t["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])


def train_mfu(rec, moves):
    """The model FLOPs of the trained songs' true lengths (a forward and
    a backward of twice its products) over the host clock of the untraced
    steps, against the f32 peak of three TF32 products a product."""
    if moves not in rec["e2e"] or rec["trace"] is None \
            or rec["untraced_s"] <= 0:
        return None
    flops = sum(costs.amt_train_flops(rec["cfg"], n)
                for item in rec["untraced"] for n in item["rows"][2])
    return 100.0 * flops / rec["untraced_s"] / costs.PEAK_FLOPS["f32"]


def loader_wait_pct(rec, moves):
    """The window's time spent waiting on the loader's next batch (the
    benchmark's span ``bench.loader_next``), as a share of the window."""
    if moves not in rec["e2e"] or rec["trace"] is None:
        return None
    wait = sum(t1 - t0 for name, t0, t1 in rec["spans"]
               if name == "bench.loader_next")
    return 100.0 * wait / rec["window_s"]
