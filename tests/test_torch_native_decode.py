"""The port's native JPEG decoder (``data/native_decode.py`` over its own
``data/native/ghdata.cc``, built at first use by ``core/kernels/_build.py``)
against the JAX package's (``genhancer_tpu/data/native_decode.py`` over
``genhancer_tpu/data/native/ghdata.cc``, built by its Makefile), both
built here from their own copies, and the loaders on it, on the CPU.

* The decoded pixels, the headers' sizes and the ok flags equal JAX's bit
  for bit (center crop and random crop from the same generator, a bad
  JPEG, a grey one); against PIL the center crop on smooth images within
  JAX's own bound (mean |native - PIL| < 0.02,
  ``tests/test_native_decode.py``).
* The loaders' batches equal the JAX loaders' on the same shard bit for
  bit: image training (random crop) and eval (center crop), and the four
  video modes (center crop per frame).
* ``which()`` names the decoder; with ``GENHANCER_NATIVE_DECODE=0`` it is
  PIL, and so is a build that fails.
Skipped where the JAX package's decoder cannot be built (no libjpeg), as
its own tests skip.
"""

import io

import numpy as np
import pytest
from PIL import Image

from genhancer_tpu.data import cc3m as jcc3m
from genhancer_tpu.data import native_decode as jnd
from genhancer_tpu.data import video as jvideo
from genhancer_tpu.data.testing import make_video_shard as jax_make_video_shard
from genhancer_tpu_torch.core.kernels import _build
from genhancer_tpu_torch.data import cc3m, native_decode as nd, testing, video
from genhancer_tpu_torch.data.transforms import eval_image_transform


@pytest.fixture(scope="module", autouse=True)
def both_built():
    if not jnd.available():
        pytest.skip("the JAX package's native decoder is not built (no libjpeg)")
    assert nd.available(), nd.which()


def _jpeg(arr, quality=90, mode=None):
    b = io.BytesIO()
    Image.fromarray(arr, mode).save(b, format="JPEG", quality=quality)
    return b.getvalue()


@pytest.fixture(scope="module")
def blobs():
    rng = np.random.default_rng(0)
    out = [_jpeg(rng.integers(0, 255, s + (3,), dtype=np.uint8))
           for s in [(480, 640), (100, 80), (224, 224), (37, 301)]]
    out.append(_jpeg(rng.integers(0, 255, (50, 70), dtype=np.uint8), mode="L"))
    return out + [b"garbage"]


def test_pixels_equal_jax_bit_for_bit(blobs):
    np.testing.assert_array_equal(nd.get_dims(blobs), jnd.get_dims(blobs))
    for size in (32, 64, 224):
        a, oka = nd.decode_batch_center(blobs, size, num_threads=3)
        b, okb = jnd.decode_batch_center(blobs, size, num_threads=3)
        np.testing.assert_array_equal(oka, okb)
        np.testing.assert_array_equal(a, b)
        assert oka.tolist() == [True] * 5 + [False] and not a[-1].any()
        a, _ = nd.decode_batch_random_crop(blobs, size, np.random.default_rng(7))
        b, _ = jnd.decode_batch_random_crop(blobs, size, np.random.default_rng(7))
        np.testing.assert_array_equal(a, b)


def test_center_crop_matches_pil_on_smooth():
    for shape in [(480, 640), (100, 80), (224, 224)]:
        g = np.linspace(0, 255, shape[1], dtype=np.uint8)[None, :, None]
        blob = _jpeg(np.broadcast_to(g, shape + (3,)).copy(), quality=95)
        imgs, ok = nd.decode_batch_center([blob], 64)
        assert ok.all() and np.abs(imgs[0] - eval_image_transform(blob, 64)).mean() < 0.02


@pytest.mark.parametrize("train", [True, False])
def test_image_loader_batches_equal_jax(tmp_path, train):
    shard = testing.make_image_shard(str(tmp_path / "s.tar"), 10, 72, seed=2)
    kw = dict(train_batch_size=3, num_workers=2, img_dir=[shard], img_size=40, seed=5,
              shuffle_buffer=4, repeat=False, train=train)
    ours, ref = list(cc3m.loader(**kw)), list(jcc3m.loader(**kw))
    assert len(ours) == len(ref) == 4
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a["image"], b["image"])
        assert a["text"] == b["text"]


@pytest.mark.parametrize("mode, kw", [
    ("triplet", {}), ("next", {}), ("next2", {}),
    ("sliding", {"max_windows_per_video": 3, "max_frames_per_video": 7}),
])
def test_video_loader_batches_equal_jax(tmp_path, mode, kw):
    path = str(tmp_path / "v.tar")
    jax_make_video_shard(path, num_videos=5, frames_per_video=9, img_size=40, seed=4)
    common = dict(video_dir=path, train_batch_size=2, num_workers=2, img_size=24, seed=7,
                  shuffle_buffer=3, repeat=False, **kw)
    ours, ref = list(video.loader(mode=mode, **common)), list(jvideo.loader(mode=mode,
                                                                             **common))
    assert len(ours) == len(ref) > 0
    for a, b in zip(ours, ref):
        assert set(a) == set(b)
        for k in ("cond", "target", "valid"):
            np.testing.assert_array_equal(a[k], b[k])


def test_which_names_the_decoder(monkeypatch, tmp_path):
    assert nd.which() == "native (ghdata.cc, libjpeg)"
    fresh = {"lib": None, "tried": False, "why": ""}
    monkeypatch.setattr(nd, "_state", dict(fresh))
    monkeypatch.setenv("GENHANCER_NATIVE_DECODE", "0")
    assert not nd.available() and nd.which() == "PIL (GENHANCER_NATIVE_DECODE=0)"
    monkeypatch.delenv("GENHANCER_NATIVE_DECODE")
    # a build that fails (a source the compiler refuses) leaves PIL, with its reason
    bad = tmp_path / "ghdata.cc"
    bad.write_text("#include <no_such_header.h>\n")
    monkeypatch.setattr(nd, "SOURCE", bad)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(nd, "_state", dict(fresh))
    assert not nd.available() and "native build unavailable" in nd.which()
    with pytest.raises(RuntimeError, match="not available"):
        nd.get_dims([b"x"])
