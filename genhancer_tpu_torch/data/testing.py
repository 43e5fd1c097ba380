"""Synthetic webdataset fixtures for tests and smoke training.

Carried over from ``genhancer_tpu/data/testing.py`` (image shards): tiny
tar shards of ``{key}.jpg + {key}.txt`` in the CC3M layout.
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
