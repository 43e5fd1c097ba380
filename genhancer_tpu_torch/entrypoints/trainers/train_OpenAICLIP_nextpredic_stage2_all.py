#!/usr/bin/env python
"""Reference-compatible training entry (train_OpenAICLIP_nextpredic_stage2_all) for the PyTorch port:
``genhancer-train-torch --trainer train_OpenAICLIP_nextpredic_stage2_all`` (``tasks.factory.TRAINER_COMPAT``),
as the JAX package's ``trainers/train_OpenAICLIP_nextpredic_stage2_all.py``.  Runs on the card unless
``--device cpu``.
"""
import sys

TRAINER = "train_OpenAICLIP_nextpredic_stage2_all"


def main(argv=None):
    from genhancer_tpu_torch.cli.train import main as train
    return train((sys.argv[1:] if argv is None else list(argv)) + ["--trainer", TRAINER])


if __name__ == "__main__":
    main()
