"""Device ms per optimizer step of the kernels the autograd engine's threads
launched: the DiT's and the projectors' (or the adapter's) backward."""

UNIT = "ms"


def read(ctx):
    tr = ctx["trace"]
    s = tr["span_s"].get("backward", 0.0)
    return 1000.0 * s / tr["steps"] if s > 0 and tr["steps"] else None
