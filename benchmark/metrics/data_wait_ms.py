"""Host ms per optimizer step spent in ``next()`` on the trainer's
prefetched batches, over the window's unprofiled steps."""

UNIT = "ms"


def read(ctx):
    w = ctx["window"]
    return 1000.0 * w["wait_s"] / w["steps"] if w["steps"] else None
