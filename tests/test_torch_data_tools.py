"""The port's data tools against the JAX package's, on the CPU:
``data/image_utils.py`` (numpy) and the video converter
(``data/convert/video_to_wds.py`` with ``cli/convert_dataset.py``).

* ``image_utils``: every function on the same inputs gives JAX's arrays bit
  for bit (and ``resize_image_with_pad``'s unpad closure the same crop).
* The converter: on the same synthetic videos, every dataset type writes
  the same shard files as JAX's converter, byte for byte, and the CLI the
  same as JAX's CLI.  It needs OpenCV (``cv2``), which only the host that
  prepares data needs: skipped without it, as ``tests/test_convert.py``.
"""

import os

import numpy as np
import pytest

from genhancer_tpu.data import image_utils as JU
from genhancer_tpu_torch.data import image_utils as U


def _images(rng):
    return {"rgb": rng.integers(0, 256, (37, 53, 3), dtype=np.uint8),
            "gray": rng.integers(0, 256, (20, 30), dtype=np.uint8),
            "gray1": rng.integers(0, 256, (20, 30, 1), dtype=np.uint8),
            "rgba": rng.integers(0, 256, (16, 24, 4), dtype=np.uint8),
            "tall": rng.integers(0, 256, (90, 40, 3), dtype=np.uint8)}


def test_image_utils_equal_jax():
    imgs = _images(np.random.default_rng(0))
    for name, img in imgs.items():
        np.testing.assert_array_equal(U.HWC3(img), JU.HWC3(img), err_msg=name)
        np.testing.assert_array_equal(U.c_crop(img), JU.c_crop(img), err_msg=name)
        for ratio in ("16:9", "4:3", "1:1"):
            np.testing.assert_array_equal(U.crop_to_aspect_ratio(img, ratio),
                                          JU.crop_to_aspect_ratio(img, ratio))
        for res in (0, 17, 64, 100):
            a, rm_a = U.resize_image_with_pad(img, res)
            b, rm_b = JU.resize_image_with_pad(img, res)
            np.testing.assert_array_equal(a, b, err_msg=f"{name} {res}")
            np.testing.assert_array_equal(rm_a(a), rm_b(b), err_msg=f"{name} {res}")
    for x in (0, 1, 63, 64, 65, 1000):
        assert U.pad64(x) == JU.pad64(x)
    rng = np.random.default_rng(1)
    images = [rng.standard_normal((3, h, w)).astype(np.float32)
              for h, w in ((16, 24), (8, 8), (24, 16))]
    sizes = [(h // 4, w // 4) for _, h, w in (im.shape for im in images)]
    for got, want in zip(U.collate_anyres(images, sizes, 4, max_size=64),
                         JU.collate_anyres(images, sizes, 4, max_size=64)):
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


@pytest.fixture(scope="module")
def video_dir(tmp_path_factory):
    cv2 = pytest.importorskip("cv2")
    d = tmp_path_factory.mktemp("videos")
    for cls, n in (("walk", 3), ("run", 2)):
        (d / cls).mkdir()
        for i in range(n):
            w = cv2.VideoWriter(str(d / cls / f"v{i}.mp4"), cv2.VideoWriter_fourcc(*"mp4v"),
                                8, (64, 64))
            for f in range(10 + i):
                frame = np.full((64, 64, 3), 30 + 10 * i, np.uint8)
                x = (f * 4) % 48
                frame[10:26, x:x + 16] = (200, 60, 60)
                w.write(frame)
            w.release()
    return str(d)


def _files(root):
    return {name: open(os.path.join(root, name), "rb").read()
            for name in sorted(os.listdir(root))}


@pytest.mark.parametrize("kw", [
    dict(dataset_type="triplet", sample_mode="fixed", max_frames=8, shard_size=2,
         method="ssim"),
    dict(dataset_type="triplet", sample_mode="fps", fps_target=4.0),
    dict(dataset_type="frame_pair", sample_mode="fixed", max_frames=5,
         pair_selection_method="top_difference", pair_difference_method="pixel_diff",
         n_pairs_per_video=2, shard_size=3),
    dict(dataset_type="frame_pair", sample_mode="fixed_time", time_interval=250,
         pair_difference_method="optical_flow"),
    dict(dataset_type="full_frames", sample_mode="fixed", sample_rate=2, shard_size=1),
], ids=["triplet-ssim", "triplet-fps", "pairs-top", "pairs-time", "full"])
def test_converter_shards_equal_jax_byte_for_byte(video_dir, tmp_path, kw):
    from genhancer_tpu.data.convert import video_to_wds as JC
    from genhancer_tpu_torch.data.convert import video_to_wds as C
    n = C.convert_videos(video_dir, str(tmp_path / "ours"), **kw)
    m = JC.convert_videos(video_dir, str(tmp_path / "ref"), **kw)
    assert n == m > 0
    ours, ref = _files(tmp_path / "ours"), _files(tmp_path / "ref")
    assert list(ours) == list(ref) and ours == ref


def test_cli_equals_jax_cli(video_dir, tmp_path):
    from genhancer_tpu.cli.convert_dataset import main as jmain
    from genhancer_tpu_torch.cli.convert_dataset import main
    args = ["--input_dir", video_dir, "--dataset_type", "full_frames", "--sample_mode",
            "fixed", "--max_frames", "6", "--shard_size", "2"]
    assert main(args + ["--output_dir", str(tmp_path / "ours")]) == \
        jmain(args + ["--output_dir", str(tmp_path / "ref")]) == 5
    assert _files(tmp_path / "ours") == _files(tmp_path / "ref")
