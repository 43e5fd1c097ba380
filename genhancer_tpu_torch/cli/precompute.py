"""Precompute CLI: cache the frozen compute of a training config to shards.

    genhancer-precompute-torch --config cfg.yaml --output_dir /data/latent_shards \
        --mode latents [--augment train --variants 2] [--batch 32] [--device cuda]

Port of ``genhancer_tpu/cli/precompute.py`` with the same flags plus
``--device`` (default ``cuda``).  It reads the trainer's YAML
(``model_name``/``tower``/``clip_config`` pick the frozen models,
``data_config.img_dir`` or ``video_dir`` the source shards) and builds the
VAE and the tower as the port's trainer builds them — the task's modules,
random init from the config's seed with a generator on ``--device`` — with
float weights, as the JAX CLI does (the int8 knobs do not apply to the
cache); then it writes ``pre-%06d.tar`` shards (``data.precompute``).
Train on them with::

    data_config:
      img_dir: /data/latent_shards
      precomputed: latents          # --mode latents: every stage
      # precomputed: true           # --mode features: stage 1 only

``--mode latents`` caches the VAE's moments and the crop (image mode
only); ``--mode features`` the moments and the tower's features (image: the
class token; video: also the patch tokens).  Images default to
``--augment train``: ``--variants`` i.i.d. training crops per image, one
drawn per visit by the loader; ``--augment center`` caches one center crop.
"""

from __future__ import annotations

import argparse
import dataclasses
import logging
import os
import time

log = logging.getLogger("genhancer_tpu_torch.precompute")


def build_frozen_modules(cfg, device):
    """(spec, modules) of ``cfg``'s task on ``device``, drawn from the
    config's seed as ``Trainer`` draws them, with every int8 knob off; the
    DiT is dropped after its draws."""
    import torch

    from ..serve.engine import resolve_device
    from ..tasks import factory
    from ..tasks import image as image_task
    from ..tasks import video as video_task

    dev = resolve_device(device)
    spec, _, ckpt_kind = factory.build_spec(cfg)
    spec = dataclasses.replace(spec, tower_quant="none", vae_quant="none", dit_quant="none",
                               dit_quant_cache=False)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(cfg.get("seed", 0)))
    task = image_task if ckpt_kind == "image" else video_task
    modules = task.init_modules(spec, gen, device=dev)
    del modules["dit"]
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return spec, modules


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description="genhancer precompute (PyTorch)")
    parser.add_argument("--config", required=True, help="path to YAML config")
    parser.add_argument("--output_dir", required=True)
    parser.add_argument("--batch", type=int, default=32)
    parser.add_argument("--samples_per_shard", type=int, default=2000)
    parser.add_argument("--augment", choices=("train", "center"), default="train",
                        help="image mode: 'train' caches --variants i.i.d. RandomResizedCrop "
                             "draws per image; 'center' one center crop")
    parser.add_argument("--variants", type=int, default=1,
                        help="training crops per image (augment=train); set K >= the "
                             "epochs so that revisits get fresh crops")
    parser.add_argument("--mode", choices=("features", "latents"), default="features",
                        help="features: moments + tower features (stage-1 cache); latents: "
                             "moments + the crop pixels (stage-2 cache, every stage)")
    parser.add_argument("--device", default="cuda",
                        help="torch device to run the frozen models on (cuda, cuda:N, cpu)")
    args = parser.parse_args(argv)

    logging.basicConfig(
        format="%(asctime)s - %(levelname)s - %(name)s - %(message)s",
        datefmt="%m/%d/%Y %H:%M:%S", level=logging.INFO)

    from ..data import precompute as pre
    from ..train.config import load_config

    cfg = load_config(args.config)
    dc = cfg.get("data_config", {}) or {}
    img_size = int(dc.get("img_size", 224))
    is_video = "video_dir" in dc
    src = dc.get("video_dir") if is_video else dc.get("img_dir")
    if not src:
        parser.error("data_config must contain img_dir or video_dir")
    if args.mode == "latents" and is_video:
        parser.error("--mode latents is image-only (the video stage-2 hot path is the "
                     "n_cond-frame tower pass, not the target frame's VAE encode)")

    spec, modules = build_frozen_modules(cfg, args.device)
    if args.mode == "latents":
        fn = pre.make_frozen_latent_fn(modules["vae"], spec.vae_cfg, vae_dtype=spec.vae_dtype)
    else:
        fn = pre.make_frozen_fn(spec.tower_kind, modules["clip"]["model"], spec.tower_cfg,
                                modules["vae"], spec.vae_cfg, vae_dtype=spec.vae_dtype,
                                compute_dtype=spec.compute_dtype, with_patches=is_video)
    t0 = time.perf_counter()
    if is_video:
        n = pre.precompute_video_dir(src, args.output_dir, fn, img_size, batch=args.batch,
                                     samples_per_shard=args.samples_per_shard)
        log.info("cached %d video frames -> %s", n, args.output_dir)
        return {"written": n, "output_dir": args.output_dir}
    if args.augment == "center":
        log.warning("augment=center fixes the crop per sample (a center crop in place of "
                    "RandomResizedCrop); the default augment=train keeps the augmentation")
    n = pre.precompute_image_dir(src, args.output_dir, fn, img_size, batch=args.batch,
                                 samples_per_shard=args.samples_per_shard,
                                 augment=args.augment, variants=args.variants,
                                 seed=int(cfg.get("seed", 0)), mode=args.mode)
    seconds = time.perf_counter() - t0
    n_bytes = sum(os.path.getsize(os.path.join(args.output_dir, f))
                  for f in os.listdir(args.output_dir))
    log.info("cached %d images (%d variants each) -> %s: %d bytes in %.1f s (%.1f images/s)",
             n, args.variants if args.augment == "train" else 1, args.output_dir, n_bytes,
             seconds, n / max(seconds, 1e-9))
    return {"written": n, "output_dir": args.output_dir, "bytes": n_bytes, "seconds": seconds}


def cli() -> None:
    """Console-script entry (the result dict would become the exit status)."""
    main()


if __name__ == "__main__":
    cli()
