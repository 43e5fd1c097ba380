"""genhancer-verify-weights-torch — the real-weights readiness check
(PyTorch port of ``genhancer_tpu/cli/verify_weights.py``).

Given a local HF tower directory it runs

  1. the tower-parity digest: the directory loaded by the port's
     ``registry.load_tower`` and, where ``transformers`` is installed, by
     ``transformers.CLIPModel``; both embed one seeded synthetic batch, and
     the digest reports max|Δ| of the image and text embeddings and of the
     normalised logits (without ``transformers``: ``hf_loaded: false`` and
     the error);
  2. micro-MMVP: the benchmark directory through ``eval.mmvp`` on its
     first ``--max-pairs`` pairs (0 = all).

Output: one JSON object on stdout; exit code 1 if the digest exceeds
``--tol``.  The port's side runs on ``--device`` (default ``cuda``; float32
with TF32 off), ``transformers`` on the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np


def parity_digest(model_dir: str, tower: str, clip_image_size: int,
                  clip_type=None, device="cuda") -> dict:
    import torch

    from .. import registry
    from ..models.towers import clip as clip_m
    from ..models.towers import siglip as siglip_m
    from ..serve.engine import resolve_device

    if not os.path.isdir(model_dir):
        raise FileNotFoundError(
            f"model_dir {model_dir!r} does not exist — digesting a "
            "random-init tower would report meaningless parity")
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    kind, cfg = registry.tower_family_and_config(tower, clip_image_size, clip_type)
    model, cfg = registry.load_tower(kind, cfg, model_dir, device=dev)
    img_size = cfg.vision.image_size
    rng = np.random.default_rng(0)
    pixels = rng.random((2, img_size, img_size, 3)).astype(np.float32)
    vocab = cfg.text.vocab_size
    ids = rng.integers(3, max(4, vocab - 1), (2, 8)).astype(np.int64)
    ids[:, -1] = getattr(cfg.text, "eos_token_id", 2)
    mod = siglip_m if kind == "siglip" else clip_m

    # NHWC pixels — the entry points the MMVP harness embeds through
    with torch.no_grad():
        pimg = mod.get_image_features(model, torch.from_numpy(pixels).to(dev), cfg)
        ptxt = mod.get_text_features(model, torch.from_numpy(ids).to(dev), cfg)
    pimg, ptxt = pimg.float().cpu().numpy(), ptxt.float().cpu().numpy()

    out = {"framework_image_embed_norm": float(np.linalg.norm(pimg)),
           "framework_text_embed_norm": float(np.linalg.norm(ptxt))}
    try:
        from transformers import CLIPModel, SiglipModel
        hf = (SiglipModel if kind == "siglip" else CLIPModel).from_pretrained(model_dir).eval()
        with torch.no_grad():
            himg = hf.get_image_features(
                pixel_values=torch.from_numpy(pixels.transpose(0, 3, 1, 2))).numpy()
            htxt = hf.get_text_features(input_ids=torch.from_numpy(ids)).numpy()
        out["hf_loaded"] = True
        out["image_embed_max_abs_diff"] = float(np.max(np.abs(pimg - himg)))
        out["text_embed_max_abs_diff"] = float(np.max(np.abs(ptxt - htxt)))
        pi = pimg / np.linalg.norm(pimg, axis=-1, keepdims=True)
        pt = ptxt / np.linalg.norm(ptxt, axis=-1, keepdims=True)
        hi = himg / np.linalg.norm(himg, axis=-1, keepdims=True)
        ht = htxt / np.linalg.norm(htxt, axis=-1, keepdims=True)
        out["logits_max_abs_diff"] = float(np.max(np.abs(pi @ pt.T - hi @ ht.T)))
    except Exception as e:  # transformers missing / incompatible dir
        out["hf_loaded"] = False
        out["hf_error"] = f"{type(e).__name__}: {e}"
    return out


def micro_mmvp(model_dir: str, benchmark_dir: str, tower: str,
               clip_image_size: int, clip_type, base_model_dir,
               max_pairs: int, device="cuda") -> dict:
    from ..eval import mmvp

    if max_pairs:
        # a truncated pair list through the same code path
        orig = mmvp.load_pairs
        mmvp.load_pairs = lambda d: orig(d)[:max_pairs]
    try:
        return mmvp.evaluate_model_dir(
            model_dir, benchmark_dir, tower=tower,
            clip_image_size=clip_image_size, clip_type=clip_type,
            base_model_dir=base_model_dir, device=device)
    finally:
        if max_pairs:
            mmvp.load_pairs = orig


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Verify local pretrained/exported tower weights: "
                    "port-vs-HF parity digest + micro-MMVP smoke (PyTorch).")
    ap.add_argument("--model-dir", required=True, help="local HF tower dir")
    ap.add_argument("--tower", default="openai_clip",
                    choices=["openai_clip", "siglip", "metaclip"])
    ap.add_argument("--clip-image-size", type=int, default=224)
    ap.add_argument("--clip-type", default=None, choices=[None, "large", "huge"])
    ap.add_argument("--benchmark-dir", default=None,
                    help="MMVP-VLM dir (Questions.csv + 'MLLM_VLM Images/'); "
                         "omit to run the parity digest only")
    ap.add_argument("--base-model-dir", default=None,
                    help="tokenizer/processor source when the export dir "
                         "lacks them (reference eval semantics)")
    ap.add_argument("--max-pairs", type=int, default=2,
                    help="pairs for the MMVP smoke (0 = full benchmark)")
    ap.add_argument("--tol", type=float, default=5e-3,
                    help="max allowed embed |Δ| vs transformers")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the port's side (cuda, cuda:N, cpu)")
    args = ap.parse_args(argv)

    result = {"model_dir": args.model_dir, "tower": args.tower}
    result["parity"] = parity_digest(args.model_dir, args.tower, args.clip_image_size,
                                     args.clip_type, device=args.device)
    ok = True
    if result["parity"].get("hf_loaded"):
        worst = max(result["parity"]["image_embed_max_abs_diff"],
                    result["parity"]["text_embed_max_abs_diff"])
        ok = worst <= args.tol
        result["parity"]["within_tol"] = ok

    if args.benchmark_dir:
        result["mmvp"] = micro_mmvp(
            args.model_dir, args.benchmark_dir, args.tower, args.clip_image_size,
            args.clip_type, args.base_model_dir, args.max_pairs, device=args.device)

    result["ok"] = ok
    print(json.dumps(result, indent=2))
    return 0 if ok else 1


def cli():
    sys.exit(main())


if __name__ == "__main__":
    cli()
