"""One reader per per-layer metric: ``<name>.py`` with ``UNIT`` and
``read(ctx)``, which returns the metric or None where the run holds nothing
to read.  ``ctx`` (``harness.run``): ``window`` (the unprofiled steps,
rows and host seconds in ``next()``), ``window_s``, ``trace``
(``spans.read_trace`` of the profiled stretch, with its ``steps`` and the
attention calls' ``attn_shapes``), ``model``, ``ops_per_row``."""
