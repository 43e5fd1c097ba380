"""Training CLI: ``python -m genhancer_tpu_torch.cli.train --config cfg.yaml``.

Port of ``genhancer_tpu/cli/train.py`` with the same flags plus
``--device`` (default ``cuda``; ``cuda`` with no CUDA device raises at
once):

    genhancer-train-torch --config configs/MetaCLIP_large_stage1.yaml --device cuda
    genhancer-train-torch --config configs/OpenAICLIP_224_sliding_stage1.yaml --device cuda
    genhancer-train-torch --config configs/tpu_fast_stage1.yaml --device cuda
    genhancer-train-torch --config configs/MetaCLIP_large_stage2_all.yaml --device cuda
    genhancer-train-torch --config configs/OpenAICLIP_336_video_stage2_all.yaml --device cuda

The stage-1 tasks run (the image task also with the int8 stack, which the
config alone selects: ``tower_quant``, ``vae_quant``, ``dit_quant``,
``fused_optimizer: pallas``, ``optimizer_moment_bits``): ``image_stage1`` and the four video modes
``video_{middle,next,next2,sliding}_stage1``; and stage 2 in image mode
(``image_stage2_only``, ``image_stage2_all``) and in the four video modes
(``video_{middle,next,next2,sliding}_stage2_all``): LoRA on the tower, from
the stage-1 files of ``load_dir``/``load_step``, an HF export of the merged
tower at each checkpoint.

  * ``--task`` / ``--tower`` overrides (else read from the YAML);
  * ``--trainer <reference script name>`` maps a reference trainer name onto
    a task (``tasks.factory.TRAINER_COMPAT``);
  * ``--profile`` writes a ``torch.profiler`` trace of steps 2-4 to
    ``<output_dir>/profile.json`` (chrome trace format; open it in
    Perfetto or ``chrome://tracing``).  It holds the host's aten ops and,
    on a card, the device's kernels and copies; the port's spans
    (``genhancer_tpu_torch.tracing``, on for those steps) as
    ``user_annotation`` ranges: ``step``, ``input.wait``, ``input.h2d`` and
    ``input.decode`` (the prefetch thread: the decode time of each batch),
    ``frozen.vae_encode``, ``frozen.tower``, ``dit.forward``,
    ``dit.double``/``dit.single`` per block, ``dit.attention``, ``loss``,
    ``backward``, ``optim.apply``; and two counter tracks: the prefetch
    queue's depth at each take (``input.queue_depth``) and each step's
    launches of each hand-written kernel (``launches.<kernel>``).

Data parallel on N cards: launch N ranks, one process per card, with
torchrun's launcher (it sets ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``MASTER_ADDR`` and ``MASTER_PORT``; each rank trains on
``cuda:LOCAL_RANK``)::

    python -m torch.distributed.run --nproc_per_node N \
        -m genhancer_tpu_torch.cli.train --config configs/MetaCLIP_large_stage1.yaml

``train_batch_size`` is per rank (the global batch is N times it), each
rank reads its own shards, and ``shard_optimizer_state: true`` shards the
AdamW moments by rows over the ranks (ZeRO-1); ``num_devices``, where set,
must equal N.  JAX's manual contract ``GENHANCER_COORDINATOR=host:port``,
``GENHANCER_NUM_PROCS``, ``GENHANCER_PROC_ID`` is taken too.  The mesh's
other axes come from the config: ``model_parallel``, ``fsdp``,
``sequence_parallel`` (ring attention over the joint tokens; composes with
``model_parallel``) and ``pipeline_parallel`` with ``pipeline_microbatches``
(the GPipe DiT; data parallelism only), N a multiple of their product::

    python -m torch.distributed.run --nproc_per_node 2 \
        -m genhancer_tpu_torch.cli.train --config <yaml with sequence_parallel: 2>
"""

from __future__ import annotations

import argparse
import logging


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description="genhancer trainer (PyTorch)")
    parser.add_argument("--config", required=True, help="path to YAML config")
    parser.add_argument("--task", default=None,
                        help="task name (e.g. image_stage1, video_sliding_stage1)")
    parser.add_argument("--tower", default=None,
                        help="tower family: openai_clip | siglip | metaclip")
    parser.add_argument("--trainer", default=None,
                        help="reference trainer script name to emulate")
    parser.add_argument("--profile", action="store_true")
    parser.add_argument("--device", default="cuda",
                        help="torch device to train on (cuda, cuda:N, cpu)")
    args = parser.parse_args(argv)

    logging.basicConfig(
        format="%(asctime)s - %(levelname)s - %(name)s - %(message)s",
        datefmt="%m/%d/%Y %H:%M:%S", level=logging.INFO)

    from ..tasks.factory import TRAINER_COMPAT
    from ..train.config import load_config

    cfg = load_config(args.config)
    if args.trainer:
        task, tower = TRAINER_COMPAT[args.trainer.removesuffix(".py")]
        cfg["task"], cfg["tower"] = task, tower
    if args.task:
        cfg["task"] = args.task
    if args.tower:
        cfg["tower"] = args.tower
    if "task" not in cfg:
        parser.error("config must contain 'task' (or pass --task/--trainer)")

    from ..train.trainer import train_from_config
    metrics = train_from_config(cfg, profile=args.profile, device=args.device)
    logging.getLogger(__name__).info("final metrics: %s", metrics)
    return metrics


def cli() -> None:
    """Console-script entry (the result dict would become the exit status)."""
    main()


if __name__ == "__main__":
    cli()
