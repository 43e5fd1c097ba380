"""Device ms per optimizer step of the kernels launched under the trainer's
``optimizer.apply`` (``bench.optimizer``): the global-norm clip and AdamW."""

UNIT = "ms"


def read(ctx):
    tr = ctx["trace"]
    s = tr["span_s"].get("optimizer", 0.0)
    return 1000.0 * s / tr["steps"] if s > 0 and tr["steps"] else None
