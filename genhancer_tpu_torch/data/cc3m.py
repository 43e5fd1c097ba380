"""CC3M (image-text) webdataset pipeline — image-mode training input.

Port of ``genhancer_tpu/data/cc3m.py``: streaming tar shards of {jpg,
txt}, shuffle buffer, RandomResizedCrop(scale 0.9-1.0) in training or the
center crop with ``train=False``, batch collation.  Emits
``{"image": float32 [B, H, W, 3] in [0,1], "text": [str]}`` — no
normalisation here (done once on the device).

``loader(train_batch_size, num_workers, img_size, img_dir, seed, ...)``
preserves the reference loader signature (``dataset_cc3m.py:220-222``).
Where the native decoder is available (``data.native_decode``: the port's
``native/ghdata.cc``, built at first use) a batch's JPEGs decode in one
native call, the crop geometry drawn from the loader's generator in the JAX
loader's order (``_iter_native``, ``cc3m.py:56-100``); else they decode with
PIL in a thread pool (PIL releases the GIL for JPEG work).  The decoder in
use is logged once per process (``native_decode.which``).

``precomputed`` reads the shards of ``data.precompute``
(``_iter_precomputed``): ``true`` the stage-1 features cache, batches
``{moments, cls}``; ``"latents"`` the latent cache, batches ``{moments,
image}`` (the cached crop as float32).
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, Optional

import numpy as np

from .. import tracing
from .transforms import eval_image_transform, train_image_transform
from .wds import ShardStream


class CC3MLoader:
    def __init__(self, img_dir, train_batch_size: int = 16, num_workers: int = 4,
                 img_size: int = 224, seed: int = 0, patch_size: int = 1,
                 shuffle_buffer: int = 2000, train: bool = True,
                 node_index: int = 0, node_count: int = 1, repeat: bool = True,
                 precomputed=False, **_unused):
        self.batch_size = train_batch_size
        self.precomputed = precomputed
        self.img_size = img_size
        self.train = train
        self.num_workers = max(1, num_workers)
        self.rng = np.random.default_rng(seed)
        self.stream = ShardStream(img_dir, node_index=node_index,
                                  node_count=node_count,
                                  shuffle_buffer=shuffle_buffer if train else 0,
                                  seed=seed, repeat=repeat)
        self.pool = ThreadPoolExecutor(max_workers=self.num_workers)

    def _decode(self, sample) -> Optional[tuple]:
        jpg = sample.get("jpg") or sample.get("jpeg") or sample.get("png")
        if jpg is None:
            return None
        try:
            img = (train_image_transform(jpg, self.img_size, self.rng) if self.train
                   else eval_image_transform(jpg, self.img_size))
        except Exception:   # an undecodable sample is skipped, as the reference does
            return None
        txt = sample.get("txt", b"")
        return img, txt.decode("utf-8", "replace") if isinstance(txt, bytes) else str(txt)

    def _iter_native(self) -> Iterator[Dict]:
        """Batches decoded by the native library, 2 x batch JPEGs per call
        (``cc3m.py:56-100``); a JPEG it cannot decode is skipped."""
        from . import native_decode as nd
        images, texts = [], []
        sample_iter = iter(self.stream)
        done = False
        while not done:
            blobs, txts = [], []
            while len(blobs) < self.batch_size * 2:
                try:
                    s = next(sample_iter)
                except StopIteration:
                    done = True
                    break
                jpg = s.get("jpg") or s.get("jpeg")
                if jpg is None:
                    continue
                t = s.get("txt", b"")
                blobs.append(jpg)
                txts.append(t.decode("utf-8", "replace") if isinstance(t, bytes) else str(t))
            if not blobs:
                continue
            if self.train:
                arrs, ok = nd.decode_batch_random_crop(blobs, self.img_size, self.rng,
                                                       num_threads=self.num_workers)
            else:
                arrs, ok = nd.decode_batch_center(blobs, self.img_size,
                                                  num_threads=self.num_workers)
            for i in range(len(blobs)):
                if not ok[i]:
                    continue
                images.append(arrs[i])
                texts.append(txts[i])
                if len(images) == self.batch_size:
                    yield self._batch(images, texts)
                    images, texts = [], []
        if images:
            yield self._batch(images, texts)

    def _iter_precomputed(self) -> Iterator[Dict]:
        """Batches from ``.feat.npz`` shards (``cc3m.py:94-160``): one
        variant per visit where a sample holds several (the same index for
        every member, so the moments stay with their crop); a loud failure
        on a cache of the other kind or on shards holding none."""
        from .precompute import load_feat
        cols: Dict[str, list] = {}
        texts = []
        seen = loaded = 0
        want_latents = self.precomputed == "latents"

        def emit():
            out = {k: np.stack(v) for k, v in cols.items()}
            if "pixels" in out:
                out["image"] = out.pop("pixels").astype(np.float32)
            out["text"] = list(texts)
            return out

        for sample in self.stream:
            seen += 1
            blob = sample.get("feat.npz")
            if blob is None:
                if loaded == 0 and seen >= 200:
                    raise RuntimeError(
                        "precomputed image loader found no .feat.npz in the first "
                        f"{seen} samples — are these shards written by "
                        "genhancer-precompute-torch?")
                continue
            try:
                feats = load_feat(blob)
            except Exception:   # an unreadable sample is skipped
                continue
            if loaded == 0:
                if want_latents and "pixels" not in feats:
                    raise RuntimeError(
                        "precomputed: 'latents' but the cache has no pixels member — "
                        "re-run genhancer-precompute-torch --mode latents (stage 2 "
                        "trains the tower and needs the crops)")
                if not want_latents and "cls" not in feats:
                    raise RuntimeError(
                        "features cache expected (precomputed: true) but the shards "
                        "are a latents cache — set precomputed: 'latents' in data_config")
            loaded += 1
            # a stacked [K, ...] sample: K i.i.d. training crops, one drawn
            j = (int(self.rng.integers(feats["moments"].shape[0]))
                 if feats["moments"].ndim == 4 else None)
            for k, v in feats.items():
                cols.setdefault(k, []).append(v if j is None else v[j])
            t = sample.get("txt", b"")
            texts.append(t.decode("utf-8", "replace") if isinstance(t, bytes) else str(t))
            if len(texts) == self.batch_size:
                yield emit()
                cols, texts = {}, []
        if texts:
            yield emit()

    def __iter__(self) -> Iterator[Dict]:
        """The batches, each one's reading and decoding in the span
        ``input.decode`` while tracing is on."""
        return tracing.each(tracing.INPUT_DECODE, self._batches())

    def _batches(self) -> Iterator[Dict]:
        if self.precomputed:
            yield from self._iter_precomputed()
            return
        from . import native_decode as nd
        if nd.available():
            yield from self._iter_native()
            return
        images, texts = [], []
        sample_iter = iter(self.stream)
        while True:
            futures = []
            for _ in range(self.batch_size * 2):
                try:
                    futures.append(self.pool.submit(self._decode, next(sample_iter)))
                except StopIteration:
                    break
            if not futures:
                if images:
                    yield self._batch(images, texts)
                return
            for fut in futures:
                res = fut.result()
                if res is None:
                    continue
                images.append(res[0])
                texts.append(res[1])
                if len(images) == self.batch_size:
                    yield self._batch(images, texts)
                    images, texts = [], []

    def close(self) -> None:
        self.pool.shutdown(wait=True, cancel_futures=True)

    @staticmethod
    def _batch(images, texts) -> Dict:
        return {"image": np.stack(images), "text": list(texts)}


def loader(train_batch_size: int = 16, num_workers: int = 4, **kwargs) -> CC3MLoader:
    """Reference-compatible entry point (dataset_cc3m.py:220)."""
    return CC3MLoader(train_batch_size=train_batch_size,
                      num_workers=num_workers, **kwargs)
