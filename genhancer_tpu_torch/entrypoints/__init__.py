"""The port's counterparts of the JAX package's root entry points.

  * ``evaluation/evaluate_mmvp_*.py``: ``genhancer-eval-torch`` with the
    tower family preset as in the JAX package's ``evaluation/`` (six files);
  * ``trainers/train_*.py``: ``genhancer-train-torch --trainer <name>``, the
    reference trainer names of ``tasks.factory.TRAINER_COMPAT`` (fourteen);
  * ``train_scripts/scripts_train_*.sh``: ``genhancer-train-torch`` on the
    same config as the JAX package's ``train_scripts/``, one process per card
    under ``torch.distributed.run`` (fourteen).

Each Python file runs as a module, e.g.
``python -m genhancer_tpu_torch.entrypoints.evaluation.evaluate_mmvp_SigLIP_224
--benchmark_dir ... --model_dir ...``; like the CLIs they drive, they run on
the card unless ``--device cpu`` is given.
"""
