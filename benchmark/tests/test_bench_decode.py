"""The input stage, at a tiny size and with one decode thread, against the
reference's own decode of the generated shards (PIL, the path the card
takes: it has no libjpeg for the native decoder).

Image rows: the training crop of the JPEG its caption names, drawn in the
loader's order from the loader's seed.  A run cannot replay that order
(its four decode threads draw the crops as they are scheduled), so it
holds inline image rows to nothing; this test is their only check.
Sliding-window rows: four frames of one video, consecutive (each video
cycles through its pool of frames), each the center crop of that frame;
a run holds every recorded row to the same (``crops.window_rows``)."""

import io

import numpy as np
import pytest
from PIL import Image

from benchmark.reference import crops
from benchmark.traffic import generate

SIZE = 32


@pytest.fixture
def pil_only(monkeypatch):
    from genhancer_tpu_torch.data import native_decode
    monkeypatch.setattr(native_decode, "available", lambda: False)


def test_image_rows_are_the_captioned_jpegs_crops(tmp_path, pil_only):
    from genhancer_tpu_torch.data import cc3m
    p = {"kind": "images", "count": 12, "shards": 2, "short_side": [40, 64],
         "aspect": [1.0, 1.5], "quality": 90}
    generate.write(p, 2 ** 31 + 9, str(tmp_path))
    jpegs = crops.read_jpegs(str(tmp_path))
    loader = cc3m.loader(train_batch_size=4, num_workers=1, img_size=SIZE,
                         img_dir=str(tmp_path), seed=2 ** 31 + 9)
    rng = np.random.default_rng(2 ** 31 + 9)
    try:
        it = iter(loader)
        for _ in range(4):
            b = next(it)
            for row, key in zip(b["image"], b["text"]):
                img = Image.open(io.BytesIO(jpegs[key])).convert("RGB")
                want = np.asarray(crops.random_resized_crop(img, SIZE, rng), np.float32) / 255
                np.testing.assert_array_equal(row, want)
    finally:
        loader.close()


def _center(jpeg: bytes) -> np.ndarray:
    img = Image.open(io.BytesIO(jpeg)).convert("RGB")
    return np.asarray(crops.center_crop(img, SIZE), np.float32) / 255


def test_window_rows_are_consecutive_frames_of_one_video(tmp_path, pil_only):
    import tarfile
    from genhancer_tpu_torch.data import video
    p = {"kind": "videos", "count": 4, "shards": 2, "width": 40, "height": 32,
         "frames": [6, 12], "pool": 3, "quality": 90}
    paths = generate.write(p, 2 ** 31 + 10, str(tmp_path))
    pools = {}                       # video -> its pool of decoded frames, in order
    for path in paths:
        with tarfile.open(path) as tf:
            for m in tf.getmembers():
                if m.name.endswith(".jpg"):
                    vid, frame = m.name.split("/")
                    f = int(frame[len("frame_"):-len(".jpg")])
                    if f < p["pool"]:
                        pools.setdefault(vid, {})[f] = _center(tf.extractfile(m).read())
    loader = video.loader(mode="sliding", train_batch_size=2, num_workers=1, img_size=SIZE,
                          video_dir=str(tmp_path), seed=3, window_cond=3, window_stride=1,
                          max_windows_per_video=2)
    try:
        b = next(iter(loader))
    finally:
        loader.close()
    assert b["valid"].sum() == 4
    for cond, target, ok in zip(b["cond"], b["target"], b["valid"]):
        if not ok:
            continue
        frames = [*cond, target]
        hits = [(v, i) for v, pool in pools.items() for i, f in pool.items()
                if np.array_equal(f, frames[0])]
        assert hits, "the first frame is no frame of any video"
        v, i = hits[0]
        for k, f in enumerate(frames):
            np.testing.assert_array_equal(f, pools[v][(i + k) % p["pool"]])
