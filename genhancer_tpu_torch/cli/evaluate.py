"""MMVP-VLM evaluation CLI (PyTorch port of ``genhancer_tpu/cli/evaluate.py``).

    genhancer-eval-torch --benchmark_dir <MMVP-VLM dir> --model_dir <HF tower dir>
        [--tower openai_clip|siglip|metaclip] [--clip_image_size N] [--clip_type large|huge]
        [--base_model_dir ...] [--device cuda|cpu]

Runs on the card unless ``--device cpu`` is given (``cuda`` with no CUDA
device raises).  The tokenizer comes from ``transformers`` on the model (or
base model) directory.  ``--tower siglip --clip_image_size 384`` scores a
SigLIP so400m export (``siglip-so400m-patch14-384-{step}/``).
"""

from __future__ import annotations

import argparse
import json
import logging


def main(argv=None):
    parser = argparse.ArgumentParser(description="MMVP-VLM evaluation (PyTorch)")
    parser.add_argument("--benchmark_dir", required=True)
    parser.add_argument("--model_dir", required=True,
                        help="HF model dir (base or stage-2 export)")
    parser.add_argument("--tower", default="openai_clip",
                        choices=["openai_clip", "siglip", "metaclip"])
    parser.add_argument("--clip_image_size", type=int, default=224)
    parser.add_argument("--clip_type", default=None, choices=[None, "large", "huge"])
    parser.add_argument("--base_model_dir", default=None,
                        help="dir providing tokenizer/processor if model_dir lacks them")
    parser.add_argument("--results_csv", default=None)
    parser.add_argument("--model_name", default=None, help="display name")
    parser.add_argument("--device", default="cuda",
                        help="torch device to evaluate on (cuda, cuda:N, cpu)")
    args = parser.parse_args(argv)

    logging.basicConfig(level=logging.INFO)
    from ..eval.mmvp import evaluate_model_dir
    results = evaluate_model_dir(
        args.model_dir, args.benchmark_dir, tower=args.tower,
        clip_image_size=args.clip_image_size, clip_type=args.clip_type,
        base_model_dir=args.base_model_dir,
        results_csv=args.results_csv or f"Prediction_Results_{args.tower}",
        device=args.device)
    name = args.model_name or args.model_dir
    print(f"\n{name}:")
    for category, accuracy in results.items():
        print(f"  {category}: {accuracy:.2f}%")
    print(json.dumps(results))
    return results


def cli() -> None:
    """Console-script entry (the result dict would become the exit status)."""
    main()


if __name__ == "__main__":
    cli()
