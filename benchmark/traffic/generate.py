"""Synthetic webdataset shards from a traffic file's parameters and a seed.

The layouts are the port's loaders' (and GenHancer's): image shards hold
``{key}.jpg`` + ``{key}.txt`` (CC3M style), video shards
``{video}/frame_{i:06d}.jpg`` + ``{video}/frame_000000.txt`` (the HMDB51
frame converter's).  Widened from the port's ``data/testing.py`` writers to
the sizes a deployment's data has:

  * ``images``: ``count`` JPEGs in ``shards`` shards, shorter side drawn from
    ``short_side`` and aspect ratio from ``aspect``;
  * ``videos``: ``count`` videos of ``width`` x ``height`` frames, frame counts
    drawn from ``frames``; each video cycles through a pool of ``pool`` of
    its own encoded frames, since the loader's decode cost and the frames'
    sizes are what the step sees.

Content is smooth (two octaves of bicubically upsampled noise), so the
JPEGs compress and decode as photographs do rather than as white noise.
The sizes and frame counts are drawn once, independently of the seed, and
the seed only permutes them and draws the content: every seed asks the same
work in another order.  The same seed writes the same bytes.
"""

from __future__ import annotations

import io
import os
import tarfile
from concurrent.futures import ThreadPoolExecutor
from typing import List

import numpy as np
from PIL import Image

# the seed of the sizes and frame counts: fixed, so every run seed has the same work
SIZES_SEED = 20240531
ENCODE_THREADS = 4


def _noise(rng: np.random.Generator, w: int, h: int) -> tuple:
    """The random cells of one image: a 4 x 4 base and an eighth-size detail."""
    return (w, h, rng.integers(0, 256, (4, 4, 3), dtype=np.uint8),
            rng.integers(0, 256, (max(2, h // 8), max(2, w // 8), 3), dtype=np.uint8))


def _jpeg(cells: tuple, quality: int) -> bytes:
    """The cells upsampled bicubically and blended (base 0.75, detail 0.25),
    encoded as a JPEG."""
    w, h, base, detail = cells
    img = Image.blend(Image.fromarray(base).resize((w, h), Image.BICUBIC),
                      Image.fromarray(detail).resize((w, h), Image.BICUBIC), 0.25)
    buf = io.BytesIO()
    img.save(buf, format="JPEG", quality=quality)
    return buf.getvalue()


def _encode_all(cells: List[tuple], quality: int) -> List[bytes]:
    """Encode in a few threads (PIL releases the interpreter lock while it
    resizes and encodes); the draws were made in order beforehand."""
    with ThreadPoolExecutor(max_workers=ENCODE_THREADS) as pool:
        return list(pool.map(lambda c: _jpeg(c, quality), cells))


def _add(tf: tarfile.TarFile, name: str, data: bytes) -> None:
    info = tarfile.TarInfo(name)
    info.size = len(data)
    tf.addfile(info, io.BytesIO(data))


def _permuted(values: List, seed: int) -> List:
    order = np.random.default_rng(seed).permutation(len(values))
    return [values[i] for i in order]


def image_sizes(p: dict) -> List[tuple]:
    """The (width, height) of every image, independent of the run's seed."""
    rng = np.random.default_rng(SIZES_SEED)
    lo, hi = p["short_side"]
    alo, ahi = p["aspect"]
    out = []
    for _ in range(p["count"]):
        short = int(rng.integers(lo, hi + 1))
        aspect = float(rng.uniform(alo, ahi))          # long / short
        long = int(round(short * aspect))
        out.append((long, short) if rng.random() < 0.5 else (short, long))
    return out


def frame_counts(p: dict) -> List[int]:
    """The frame count of every video, independent of the run's seed."""
    lo, hi = p["frames"]
    return [int(x) for x in np.random.default_rng(SIZES_SEED).integers(lo, hi + 1, p["count"])]


def write_images(p: dict, seed: int, out_dir: str) -> List[str]:
    rng = np.random.default_rng([seed, 1])
    sizes = _permuted(image_sizes(p), seed)
    jpegs = _encode_all([_noise(rng, w, h) for w, h in sizes], p["quality"])
    os.makedirs(out_dir, exist_ok=True)
    per = -(-len(sizes) // p["shards"])
    paths = []
    for s in range(p["shards"]):
        path = os.path.join(out_dir, f"images-{s:04d}.tar")
        with tarfile.open(path, "w") as tf:
            for i in range(s * per, min(len(sizes), (s + 1) * per)):
                key = f"img{i:06d}"
                _add(tf, f"{key}.jpg", jpegs[i])
                _add(tf, f"{key}.txt", key.encode())
        paths.append(path)
    return paths


def write_videos(p: dict, seed: int, out_dir: str) -> List[str]:
    rng = np.random.default_rng([seed, 2])
    counts = _permuted(frame_counts(p), seed)
    pools = _encode_all([_noise(rng, p["width"], p["height"])
                         for _ in range(len(counts) * p["pool"])], p["quality"])
    os.makedirs(out_dir, exist_ok=True)
    per = -(-len(counts) // p["shards"])
    paths = []
    for s in range(p["shards"]):
        path = os.path.join(out_dir, f"videos-{s:04d}.tar")
        with tarfile.open(path, "w") as tf:
            for v in range(s * per, min(len(counts), (s + 1) * per)):
                vid = f"video{v:05d}"
                pool = pools[v * p["pool"]:(v + 1) * p["pool"]]
                for f in range(counts[v]):
                    _add(tf, f"{vid}/frame_{f:06d}.jpg", pool[f % len(pool)])
                _add(tf, f"{vid}/frame_000000.txt", vid.encode())
        paths.append(path)
    return paths


def write(p: dict, seed: int, out_dir: str) -> List[str]:
    """The shards of traffic parameters ``p`` for ``seed`` under ``out_dir``."""
    writers = {"images": write_images, "videos": write_videos}
    if p["kind"] not in writers:
        raise ValueError(f"traffic kind must be one of {sorted(writers)}, got {p['kind']!r}")
    return writers[p["kind"]](p, seed, out_dir)
