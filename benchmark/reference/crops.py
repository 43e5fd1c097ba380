"""The reference's own decode of the raw shards.

  * The training crops a features cache was built from: torchvision's
    ``RandomResizedCrop(size, scale=(0.9, 1.0), ratio=(3/4, 4/3))`` with
    bicubic resampling, drawn for each image from
    ``numpy.random.default_rng((seed, crc32(key)))``, GenHancer's image
    transform and the per-image generator the stage-1 cache (``--augment
    train``) uses.
  * Video frames: the shorter side resized to the size (bicubic, the other
    side truncated), then the center crop; a sliding-window row is
    ``window_cond + 1`` consecutive frames of one video.

JPEGs are decoded with PIL."""

from __future__ import annotations

import glob
import hashlib
import io
import math
import os
import tarfile
import zlib
from typing import Dict, List, Tuple

import numpy as np
from PIL import Image


def read_jpegs(shard_dir: str) -> Dict[str, bytes]:
    """``{key: jpeg bytes}`` of every ``.jpg`` member of the tars in ``shard_dir``."""
    out = {}
    for path in sorted(glob.glob(os.path.join(shard_dir, "*.tar"))):
        with tarfile.open(path) as tf:
            for m in tf.getmembers():
                if m.isfile() and m.name.endswith(".jpg"):
                    out[m.name[: -len(".jpg")]] = tf.extractfile(m).read()
    return out


def random_resized_crop(img: Image.Image, size: int, rng: np.random.Generator,
                        scale=(0.9, 1.0), ratio=(3 / 4, 4 / 3)) -> Image.Image:
    w, h = img.size
    area = w * h
    for _ in range(10):
        target = area * rng.uniform(*scale)
        aspect = math.exp(rng.uniform(math.log(ratio[0]), math.log(ratio[1])))
        cw = int(round(math.sqrt(target * aspect)))
        ch = int(round(math.sqrt(target / aspect)))
        if 0 < cw <= w and 0 < ch <= h:
            x0 = int(rng.integers(0, w - cw + 1))
            y0 = int(rng.integers(0, h - ch + 1))
            return img.resize((size, size), Image.BICUBIC, box=(x0, y0, x0 + cw, y0 + ch))
    in_ratio = w / h
    if in_ratio < ratio[0]:
        cw, ch = w, int(round(w / ratio[0]))
    elif in_ratio > ratio[1]:
        cw, ch = int(round(h * ratio[1])), h
    else:
        cw, ch = w, h
    x0, y0 = (w - cw) // 2, (h - ch) // 2
    return img.resize((size, size), Image.BICUBIC, box=(x0, y0, x0 + cw, y0 + ch))


def training_crops(jpegs: Dict[str, bytes], keys: List[str], seed: int,
                   size: int) -> np.ndarray:
    """[len(keys), size, size, 3] float32 in [0, 1]: each key's training crop."""
    out = []
    for k in keys:
        rng = np.random.default_rng((seed, zlib.crc32(k.encode())))
        img = Image.open(io.BytesIO(jpegs[k])).convert("RGB")
        out.append(np.asarray(random_resized_crop(img, size, rng), np.float32) / 255.0)
    return np.stack(out)


def center_crop(img: Image.Image, size: int) -> Image.Image:
    w, h = img.size
    nw, nh = (size, max(size, int(h * size / w))) if w <= h else \
        (max(size, int(w * size / h)), size)
    img = img.resize((nw, nh), Image.BICUBIC)
    x0, y0 = (nw - size) // 2, (nh - size) // 2
    return img.crop((x0, y0, x0 + size, y0 + size))


def _digest(a: np.ndarray) -> bytes:
    return hashlib.blake2b(np.ascontiguousarray(a).tobytes(), digest_size=16).digest()


class VideoFrames:
    """Every distinct frame JPEG of the video shards in ``shard_dir``,
    decoded once (``center_crop``, float32 in [0, 1]), and each video's
    frames in order, the first ``max_frames``, as indices into them."""

    def __init__(self, shard_dir: str, size: int, max_frames: int):
        by_bytes: Dict[bytes, int] = {}
        jpegs: List[bytes] = []
        videos: Dict[str, Dict[int, int]] = {}
        for path in sorted(glob.glob(os.path.join(shard_dir, "*.tar"))):
            with tarfile.open(path) as tf:
                for m in tf.getmembers():
                    if not (m.isfile() and m.name.endswith(".jpg")):
                        continue
                    vid, name = m.name.rsplit("/", 1)
                    data = tf.extractfile(m).read()
                    if data not in by_bytes:
                        by_bytes[data] = len(jpegs)
                        jpegs.append(data)
                    videos.setdefault(vid, {})[int(name[len("frame_"):-len(".jpg")])] = \
                        by_bytes[data]
        self.frames = [np.asarray(center_crop(Image.open(io.BytesIO(j)).convert("RGB"), size),
                                  np.float32) / 255.0 for j in jpegs]
        self.index = {_digest(f): i for i, f in enumerate(self.frames)}
        self.videos = {v: [fr[i] for i in sorted(fr)][:max_frames] for v, fr in videos.items()}

    def windows(self, n: int) -> set:
        """Every run of ``n`` consecutive frames of one video, as indices."""
        return {tuple(seq[s:s + n]) for seq in self.videos.values()
                for s in range(len(seq) - n + 1)}


def window_rows(batch: Dict[str, np.ndarray], frames: VideoFrames) -> Tuple[dict, int]:
    """The reference's own pixels of a sliding-window batch (``cond`` [B, n - 1,
    H, W, 3], ``target`` [B, H, W, 3], ``valid`` [B]): each valid row found,
    by its pixels, as ``n`` consecutive frames of one video and replaced by
    the reference's decode of them.  Returns the batch and the number of
    valid rows that are no such frames."""
    cond, target = batch["cond"].copy(), batch["target"].copy()
    n = cond.shape[1] + 1
    runs = frames.windows(n)
    off = 0
    for r in np.flatnonzero(batch["valid"]):
        ids = tuple(frames.index.get(_digest(f)) for f in (*cond[r], target[r]))
        if ids not in runs:
            off += 1
            continue
        cond[r] = np.stack([frames.frames[i] for i in ids[:-1]])
        target[r] = frames.frames[ids[-1]]
    return {**batch, "cond": cond, "target": target}, off
