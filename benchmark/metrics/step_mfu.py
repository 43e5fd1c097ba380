"""100 x the model operations of the window's training rows (``flops.
step_ops_per_row``: the frozen forward, the trained forward and backward,
no recompute) over the unprofiled window's seconds x the card's bf16 peak."""

from benchmark import flops

UNIT = "%"


def read(ctx):
    w = ctx["window"]
    if not w["rows"] or ctx["window_s"] <= 0:
        return None
    return 100.0 * ctx["ops_per_row"] * w["rows"] / (ctx["window_s"]
                                                     * flops.PEAK_OPS["bfloat16"])
