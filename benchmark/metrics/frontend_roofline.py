"""Row 1 of the kernel table, the fused conv frontend (``conv_ln_gelu*``,
seven launches a batch): its least time at the card's bf16 peak and HBM
rate (``costs.frontend_cost`` of each batch, the batch-padding rows
included, since the kernel computes them) over its device time. The
kernels seen must be the launches the program counted."""
import sys

from benchmark import costs


def read(rec):
    if "serve_rtfx" not in rec["e2e"] or rec["trace"] is None:
        return None
    t = rec["trace"]
    kernels = [k for k in t["kernels"] if "conv_ln_gelu" in k[0]]
    counted = (t["launch_counts"] or {}).get("conv_frontend", 0)
    if not kernels or len(kernels) != counted:
        print(f"frontend_roofline: {len(kernels)} kernels seen, {counted} "
              f"launches counted: not read", file=sys.stderr)
        return None
    width = int(round(rec["traffic"]["chunk_seconds"] * costs.SAMPLE_RATE))
    least = sum(costs.bound(*costs.frontend_cost(rec["cfg"], len(batch), width,
                                                 2), costs.PEAK_FLOPS["bf16"])
                for item in rec["traced"] for batch in item["rows"])
    device = sum(e - s for _, s, e, _ in kernels) / 1e9
    return 100.0 * least / device
