"""The traffic generator: the same seed writes the same bytes, another seed
other bytes, and every seed the same sizes in another order."""

import hashlib
import io
import tarfile

import pytest
from PIL import Image

from benchmark.traffic import generate

IMAGES = {"kind": "images", "count": 10, "shards": 2, "short_side": [40, 64],
          "aspect": [1.0, 1.5], "quality": 90}
VIDEOS = {"kind": "videos", "count": 4, "shards": 2, "width": 40, "height": 32,
          "frames": [5, 9], "pool": 3, "quality": 90}


def _digest(paths):
    h = hashlib.sha256()
    for p in paths:
        with open(p, "rb") as f:
            h.update(f.read())
    return h.hexdigest()


def _members(paths):
    out = {}
    for p in paths:
        with tarfile.open(p) as tf:
            for m in tf.getmembers():
                out[m.name] = tf.extractfile(m).read()
    return out


@pytest.mark.parametrize("params", [IMAGES, VIDEOS], ids=["images", "videos"])
def test_same_seed_same_bytes_other_seed_other_bytes(tmp_path, params):
    a = generate.write(params, 2 ** 31 + 3, str(tmp_path / "a"))
    b = generate.write(params, 2 ** 31 + 3, str(tmp_path / "b"))
    c = generate.write(params, 2 ** 31 + 4, str(tmp_path / "c"))
    assert _digest(a) == _digest(b)
    assert _digest(a) != _digest(c)


def test_every_seed_has_the_same_image_sizes(tmp_path):
    sizes = []
    for seed in (1, 2):
        files = _members(generate.write(IMAGES, seed, str(tmp_path / str(seed))))
        jpgs = [v for k, v in sorted(files.items()) if k.endswith(".jpg")]
        sizes.append([Image.open(io.BytesIO(j)).size for j in jpgs])
        lo, hi = IMAGES["short_side"]
        assert all(lo <= min(s) <= hi for s in sizes[-1])
    assert sorted(sizes[0]) == sorted(sizes[1]) and sizes[0] != sizes[1]


def test_every_seed_has_the_same_frame_counts(tmp_path):
    counts = []
    for seed in (1, 2):
        files = _members(generate.write(VIDEOS, seed, str(tmp_path / str(seed))))
        per = {}
        for k in files:
            if k.endswith(".jpg"):
                per[k.split("/")[0]] = per.get(k.split("/")[0], 0) + 1
        counts.append([per[v] for v in sorted(per)])
    assert sorted(counts[0]) == sorted(counts[1])
    assert all(VIDEOS["frames"][0] <= n <= VIDEOS["frames"][1] for n in counts[0])
