"""Host-side image transforms (PIL/numpy) feeding raw [0, 1] pixel batches.

Carried over from ``genhancer_tpu/data/transforms.py``:

  * image train: RandomResizedCrop(img_size, scale=(0.9, 1.0), bicubic)
    (``dataset_cc3m.py:91-121``);
  * eval / serving: resize the shorter side (bicubic, long side truncated as
    torchvision does), center crop;
  * video frames: the same resize + center crop (``dataset_video.py:53-67``,
    without the in-dataset Normalize).

Normalisation happens once, on the device (``tasks.conditioning``).
"""

from __future__ import annotations

import io
import math
from typing import Tuple

import numpy as np
from PIL import Image


def decode_image(data: bytes) -> Image.Image:
    img = Image.open(io.BytesIO(data))
    return img.convert("RGB")


def to_float01(img: Image.Image) -> np.ndarray:
    return np.asarray(img, dtype=np.float32) / 255.0


def random_resized_crop(img: Image.Image, size: int, rng: np.random.Generator,
                        scale: Tuple[float, float] = (0.9, 1.0),
                        ratio: Tuple[float, float] = (3 / 4, 4 / 3)) -> Image.Image:
    """torchvision RandomResizedCrop semantics (10 tries then center fallback)."""
    w, h = img.size
    area = w * h
    for _ in range(10):
        target_area = area * rng.uniform(*scale)
        log_ratio = (math.log(ratio[0]), math.log(ratio[1]))
        aspect = math.exp(rng.uniform(*log_ratio))
        cw = int(round(math.sqrt(target_area * aspect)))
        ch = int(round(math.sqrt(target_area / aspect)))
        if 0 < cw <= w and 0 < ch <= h:
            x0 = int(rng.integers(0, w - cw + 1))
            y0 = int(rng.integers(0, h - ch + 1))
            return img.resize((size, size), Image.BICUBIC,
                              box=(x0, y0, x0 + cw, y0 + ch))
    # fallback: central crop of the feasible aspect
    in_ratio = w / h
    if in_ratio < ratio[0]:
        cw, ch = w, int(round(w / ratio[0]))
    elif in_ratio > ratio[1]:
        cw, ch = int(round(h * ratio[1])), h
    else:
        cw, ch = w, h
    x0, y0 = (w - cw) // 2, (h - ch) // 2
    return img.resize((size, size), Image.BICUBIC, box=(x0, y0, x0 + cw, y0 + ch))


def resize_center_crop(img: Image.Image, size: int) -> Image.Image:
    """Resize shorter side to `size` (bicubic) then center crop size x size.
    The long side TRUNCATES (``int(size * long / short)``)."""
    w, h = img.size
    if w <= h:
        nw, nh = size, max(size, int(h * size / w))
    else:
        nw, nh = max(size, int(w * size / h)), size
    img = img.resize((nw, nh), Image.BICUBIC)
    x0 = (nw - size) // 2
    y0 = (nh - size) // 2
    return img.crop((x0, y0, x0 + size, y0 + size))


def train_image_transform(data: bytes, size: int, rng: np.random.Generator) -> np.ndarray:
    return to_float01(random_resized_crop(decode_image(data), size, rng))


def eval_image_transform(data: bytes, size: int) -> np.ndarray:
    return to_float01(resize_center_crop(decode_image(data), size))


# video frames take the eval transform (dataset_video.py:53-67)
video_frame_transform = eval_image_transform
