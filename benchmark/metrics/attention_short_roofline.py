"""Row 2 of the kernel table, the short attention kernel (``flash_fwd``,
one launch a layer a batch): its least time at the card's bf16 peak and HBM
rate (``costs.attention_cost`` over each row's valid keys, the chunks' true
frames) over its device time. The kernels seen must be the launches the
program counted."""
import sys

from benchmark import costs


def read(rec):
    if "serve_rtfx" not in rec["e2e"] or rec["trace"] is None:
        return None
    t, cfg = rec["trace"], rec["cfg"]
    kernels = [k for k in t["kernels"] if "flash_fwd" in k[0]]
    counted = (t["launch_counts"] or {}).get("flash_attention_short", 0)
    if not kernels or len(kernels) != counted:
        print(f"attention_short_roofline: {len(kernels)} kernels seen, "
              f"{counted} launches counted: not read", file=sys.stderr)
        return None
    width = int(round(rec["traffic"]["chunk_seconds"] * costs.SAMPLE_RATE))
    frames = costs.output_frames(cfg, width)
    heads = cfg["num_attention_heads"]
    head_dim = cfg["hidden_size"] // heads
    least = sum(cfg["num_hidden_layers"] * costs.bound(*costs.attention_cost(
        (len(batch), heads, frames, head_dim),
        [costs.output_frames(cfg, n) if n > 0 else 0 for n in batch], 2),
        costs.PEAK_FLOPS["bf16"])
        for item in rec["traced"] for batch in item["rows"])
    device = sum(e - s for _, s, e, _ in kernels) / 1e9
    return 100.0 * least / device
