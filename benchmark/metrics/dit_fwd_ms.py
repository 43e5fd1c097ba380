"""Device ms per optimizer step of the kernels launched under the DiT forward
span (``bench.dit_fwd``), its attention included."""

UNIT = "ms"


def read(ctx):
    tr = ctx["trace"]
    s = tr["span_s"].get("dit_fwd", 0.0)
    return 1000.0 * s / tr["steps"] if s > 0 and tr["steps"] else None
