"""The benchmark of the PyTorch port (``genhancer_tpu_torch``) on one card.

``python -m benchmark.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once.  Everything that
belongs to one configuration, traffic mix or per-layer metric is a file of
its own that the harness finds by name: ``configs/<config>.json``,
``workloads/<cell>.json``, ``metrics/<metric>.py``.
"""
