#!/usr/bin/env python
"""MMVP-VLM eval entry (evaluate_mmvp_MetaCLIP_huge) for the PyTorch port: ``genhancer-eval-torch``
with the tower family preset to metaclip@224, as the JAX package's
``evaluation/evaluate_mmvp_MetaCLIP_huge.py`` presets it.  Runs on the card unless ``--device cpu``.
"""
import sys

PRESET = ["--tower", "metaclip", "--clip_image_size", "224", "--clip_type", "huge"]


def main(argv=None):
    from genhancer_tpu_torch.cli.evaluate import main as evaluate
    return evaluate((sys.argv[1:] if argv is None else list(argv)) + PRESET)


if __name__ == "__main__":
    main()
