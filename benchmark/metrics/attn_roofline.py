"""100 x the DiT attention entry's least time (``flops.
attention_least_seconds`` of each call's B, L, H, D: operations at the bf16
peak or bytes at the HBM rate, forward and backward) over the device time
of the kernels its forward span and its backward marks enclose."""

from benchmark import flops

UNIT = "%"


def read(ctx):
    tr = ctx["trace"]
    dev = tr["span_s"].get("attn_fwd", 0.0) + tr["span_s"].get("attn_bwd", 0.0)
    if dev <= 0 or not tr["attn_shapes"]:
        return None
    least = sum(flops.attention_least_seconds(*s) for s in tr["attn_shapes"])
    return 100.0 * least / dev
