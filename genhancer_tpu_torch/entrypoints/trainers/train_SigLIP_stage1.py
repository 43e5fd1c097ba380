#!/usr/bin/env python
"""Reference-compatible training entry (train_SigLIP_stage1) for the PyTorch port:
``genhancer-train-torch --trainer train_SigLIP_stage1`` (``tasks.factory.TRAINER_COMPAT``),
as the JAX package's ``trainers/train_SigLIP_stage1.py``.  Runs on the card unless
``--device cpu``.
"""
import sys

TRAINER = "train_SigLIP_stage1"


def main(argv=None):
    from genhancer_tpu_torch.cli.train import main as train
    return train((sys.argv[1:] if argv is None else list(argv)) + ["--trainer", TRAINER])


if __name__ == "__main__":
    main()
