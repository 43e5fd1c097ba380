#!/usr/bin/env python
"""MMVP-VLM eval entry (evaluate_mmvp_SigLIP_384) for the PyTorch port: ``genhancer-eval-torch``
with the tower family preset to siglip@384, as the JAX package's
``evaluation/evaluate_mmvp_SigLIP_384.py`` presets it.  Runs on the card unless ``--device cpu``.
"""
import sys

PRESET = ["--tower", "siglip", "--clip_image_size", "384"]


def main(argv=None):
    from genhancer_tpu_torch.cli.evaluate import main as evaluate
    return evaluate((sys.argv[1:] if argv is None else list(argv)) + PRESET)


if __name__ == "__main__":
    main()
