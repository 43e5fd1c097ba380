"""MMVP-VLM eval presets for ``genhancer-eval-torch``."""
