"""MMVP-VLM evaluation and stage-1 reconstruction (PyTorch port of
``genhancer_tpu/eval``): :mod:`mmvp`, :mod:`reconstruct`."""

from . import mmvp  # noqa: F401
