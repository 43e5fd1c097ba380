"""Synthetic webdataset fixtures for tests and smoke training.

Carried over from ``genhancer_tpu/data/testing.py``: tiny tar shards in the
reference layouts:
  * image shards: ``{key}.jpg + {key}.txt`` (CC3M style);
  * video shards: ``{video_id}/frame_{i}.jpg + {video_id}/frame_0.txt``
    (the layout of the reference's frame converter).
"""

from __future__ import annotations

import io
import os
import tarfile

import numpy as np
from PIL import Image


def _jpeg_bytes(rng: np.random.Generator, size: int, seed_color=None) -> bytes:
    arr = rng.integers(0, 255, (size, size, 3), dtype=np.uint8)
    if seed_color is not None:
        arr = (arr * 0.3 + np.asarray(seed_color) * 0.7).astype(np.uint8)
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="JPEG", quality=90)
    return buf.getvalue()


def _add_bytes(tf: tarfile.TarFile, name: str, data: bytes) -> None:
    info = tarfile.TarInfo(name)
    info.size = len(data)
    tf.addfile(info, io.BytesIO(data))


def make_image_shard(path: str, num_samples: int = 8, img_size: int = 64,
                     seed: int = 0) -> str:
    rng = np.random.default_rng(seed)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with tarfile.open(path, "w") as tf:
        for i in range(num_samples):
            key = f"{seed:03d}{i:05d}"
            _add_bytes(tf, f"{key}.jpg", _jpeg_bytes(rng, img_size))
            _add_bytes(tf, f"{key}.txt", f"caption {i}".encode())
    return path


def make_video_shard(path: str, num_videos: int = 4, frames_per_video: int = 6,
                     img_size: int = 64, seed: int = 0) -> str:
    """``frames_per_video``: one count for every video, or one per video."""
    rng = np.random.default_rng(seed)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    counts = ([frames_per_video] * num_videos if isinstance(frames_per_video, int)
              else list(frames_per_video))
    with tarfile.open(path, "w") as tf:
        for v, n_frames in enumerate(counts):
            vid = f"video_{seed:02d}_{v:04d}"
            color = rng.integers(0, 255, 3)
            for f in range(n_frames):
                _add_bytes(tf, f"{vid}/frame_{f}.jpg", _jpeg_bytes(rng, img_size, color))
            _add_bytes(tf, f"{vid}/frame_0.txt", f"video {v}".encode())
    return path
