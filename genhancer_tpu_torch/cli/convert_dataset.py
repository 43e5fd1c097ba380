"""Dataset conversion CLI — video folders -> webdataset tar shards.

    python -m genhancer_tpu_torch.cli.convert_dataset --input_dir videos/ \
        --output_dir shards/ --dataset_type full_frames

Port of ``genhancer_tpu/cli/convert_dataset.py``; the shards are byte for
byte those of the JAX converter.  It runs on the host only and needs OpenCV
(``cv2``), which the training machines need not have.

Flag-compatible with the reference converters
(``convert_hdmb_to_webdataset.py:506-558`` /
``convert_webm_to_webdataset.py``): dataset_type triplet|frame_pair|
full_frames, sampling modes, selection methods, shard size.
"""

from __future__ import annotations

import argparse
import logging


def main(argv=None):
    p = argparse.ArgumentParser(
        description="Convert a folder of videos into WebDataset tar shards.")
    p.add_argument("--input_dir", required=True)
    p.add_argument("--output_dir", required=True)
    p.add_argument("--dataset_type", default="triplet",
                   choices=["triplet", "frame_pair", "full_frames"])
    p.add_argument("--sample_mode", default="fps",
                   choices=["fixed", "fps", "fixed_time"])
    p.add_argument("--sample_rate", type=int, default=1)
    p.add_argument("--fps_target", type=float, default=8.0)
    p.add_argument("--time_interval", type=int, default=1000)
    p.add_argument("--max_frames", type=int, default=None)
    p.add_argument("--shard_size", type=int, default=1000)
    p.add_argument("--method", default="optical_flow",
                   choices=["ssim", "optical_flow"])
    p.add_argument("--pair_selection_method", default="all",
                   choices=["all", "top_difference"])
    p.add_argument("--pair_difference_method", default="optical_flow",
                   choices=["optical_flow", "pixel_diff", "ssim"])
    p.add_argument("--n_pairs_per_video", type=int, default=None)
    p.add_argument("--top_percent", type=float, default=0.3)
    args = p.parse_args(argv)

    logging.basicConfig(level=logging.INFO)
    from ..data.convert.video_to_wds import convert_videos
    n = convert_videos(
        args.input_dir, args.output_dir, dataset_type=args.dataset_type,
        sample_mode=args.sample_mode, sample_rate=args.sample_rate,
        fps_target=args.fps_target, time_interval=args.time_interval,
        max_frames=args.max_frames, shard_size=args.shard_size,
        method=args.method, pair_selection_method=args.pair_selection_method,
        pair_difference_method=args.pair_difference_method,
        n_pairs_per_video=args.n_pairs_per_video, top_percent=args.top_percent)
    print(f"wrote {n} samples")
    return n


if __name__ == "__main__":
    main()
