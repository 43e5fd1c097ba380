"""Reconstruction CLI (PyTorch port of ``genhancer_tpu/cli/reconstruct.py``).

    genhancer-reconstruct-torch --config cfg.yaml --image in.jpg --load_dir out/
        --load_step 1000 [--output_dir recon/] [--num_steps 20] [--device cuda|cpu]

Loads the image stage-1 files of ``load_step`` from ``load_dir`` (the other
weights random from ``--seed``, the tower from ``clip_config.model_dir``)
and writes ``input.jpg`` and ``reconstruction.jpg``.  Runs on the card
unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import logging


def main(argv=None):
    parser = argparse.ArgumentParser(description="stage-1 reconstruction (PyTorch)")
    parser.add_argument("--config", required=True)
    parser.add_argument("--image", required=True)
    parser.add_argument("--load_dir", required=True)
    parser.add_argument("--load_step", type=int, required=True)
    parser.add_argument("--output_dir", default="reconstruction_out")
    parser.add_argument("--num_steps", type=int, default=20)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", default="cuda",
                        help="torch device to run on (cuda, cuda:N, cpu)")
    args = parser.parse_args(argv)

    logging.basicConfig(level=logging.INFO)
    from ..eval.reconstruct import reconstruct_from_checkpoints
    from ..tasks import factory
    from ..train.config import load_config

    cfg = load_config(args.config)
    cfg.setdefault("task", "image_stage1")
    spec, _, ckpt_kind = factory.build_spec(cfg)
    if ckpt_kind != "image":
        raise ValueError(f"reconstruction reads image stage-1 checkpoints; task "
                         f"{cfg['task']!r} is a {ckpt_kind} task")
    out = reconstruct_from_checkpoints(
        spec, args.load_dir, args.load_step, args.image, args.output_dir,
        num_steps=args.num_steps, seed=args.seed, device=args.device)
    print(f"reconstruction written to {out}")
    return out


def cli() -> None:
    """Console-script entry (the result would become the exit status)."""
    main()


if __name__ == "__main__":
    cli()
