"""Video webdataset pipelines — all four conditioning modes.

Port of ``genhancer_tpu/data/video.py`` (the PIL thread-pool path).  Every
mode emits the same batch::

    {"cond":   float32 [B, n_cond, H, W, 3] in [0, 1],
     "target": float32 [B, H, W, 3],
     "valid":  bool [B]}

so one video task (``tasks.video``) serves all four trainers:

  * ``TripletLoader`` (middle): cond (first, last) -> target middle;
  * ``NextFrameLoader`` (next): cond (a random frame) -> target its successor;
  * ``TwoFrameLoader`` (next2): cond (first, middle) -> target last;
  * ``SlidingWindowLoader`` (sliding): per video, up to
    ``max_windows_per_video`` windows of ``window_cond`` frames and their
    successor, sampled without replacement; a batch holds the windows of
    ``train_batch_size`` videos, padded to the static
    ``train_batch_size * max_windows_per_video`` rows with ``valid=False``,
    plus the extras ``avg_windows_per_video`` and ``bs_eff``.

The same seed and the same shards give the same windows as the JAX loaders
(the same ``np.random.default_rng`` draws in the same order).  Frames are
decoded by the native library where it is available (``data.native_decode``,
one call per example's frames, the center crop; ``video.py:60-65``), else
with PIL in a thread pool.  With ``precomputed`` the frames are
``.feat.npz`` members of the video features cache (``data.precompute``) and every loader emits
``{cond_patches, cond_vecs, moments, valid}`` (``_assemble_precomputed``).
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, List, Optional

import numpy as np

from .. import tracing
from .transforms import video_frame_transform
from .wds import ShardStream


def _assemble_precomputed(cond_feats: List[Dict], target_feats: Dict) -> Dict:
    """A cached example (``video.py:32-40``): the patches stay float16 (the
    loss casts them to the compute dtype on the device)."""
    return {"cond_patches": np.stack([f["patches"] for f in cond_feats]),
            "cond_vecs": np.stack([f["cls"] for f in cond_feats]),
            "moments": target_feats["moments"]}


class VideoLoaderBase:
    def __init__(self, video_dir, train_batch_size: int = 4, num_workers: int = 4,
                 img_size: int = 224, seed: int = 0, shuffle_buffer: int = 100,
                 node_index: int = 0, node_count: int = 1, repeat: bool = True,
                 precomputed: bool = False, **_unused):
        self.batch_size = train_batch_size
        self.precomputed = precomputed
        self.img_size = img_size
        self.rng = np.random.default_rng(seed)
        self.stream = ShardStream(video_dir, node_index=node_index,
                                  node_count=node_count,
                                  shuffle_buffer=shuffle_buffer, seed=seed,
                                  repeat=repeat, group_videos=True)
        self.num_workers = max(1, num_workers)
        self.pool = ThreadPoolExecutor(max_workers=self.num_workers)

    def _decode_frames(self, frames: List, indices: List[int]) -> Optional[np.ndarray]:
        from . import native_decode as nd
        if nd.available():
            arrs, ok = nd.decode_batch_center([frames[i][1] for i in indices], self.img_size,
                                              num_threads=self.num_workers)
            return arrs if bool(ok.all()) else None
        try:
            return np.stack(list(self.pool.map(
                lambda i: video_frame_transform(frames[i][1], self.img_size), indices)))
        except Exception:   # an undecodable frame skips the example, as the reference does
            return None

    def _gather(self, frames: List, cond_idx: List[int], target_idx: int) -> Optional[Dict]:
        """One example: {cond, target} from pixels, or the cached features'
        {cond_patches, cond_vecs, moments} (``video.py:76-91``)."""
        if self.precomputed:
            from .precompute import load_feat
            try:
                feats = [load_feat(frames[i][1]) for i in cond_idx]
                tgt = load_feat(frames[target_idx][1])
            except Exception:   # an unreadable frame skips the example
                return None
            return _assemble_precomputed(feats, tgt)
        arr = self._decode_frames(frames, cond_idx + [target_idx])
        if arr is None:
            return None
        return {"cond": arr[:-1], "target": arr[-1]}

    def sample_to_example(self, video) -> Optional[Dict]:
        raise NotImplementedError

    def _check_yields(self, seen: int, produced: int) -> None:
        """A precomputed stream that yields nothing is a configuration error
        (pixel shards under ``precomputed: true``): fail rather than spin."""
        if self.precomputed and produced == 0 and seen >= 100:
            raise RuntimeError(
                f"precomputed video loader produced 0 examples from the first {seen} "
                "videos — are these .feat.npz shards written by genhancer-precompute-torch "
                "(not pixel shards)?")

    def __iter__(self) -> Iterator[Dict]:
        """The batches, each one's reading and decoding in the span
        ``input.decode`` while tracing is on."""
        return tracing.each(tracing.INPUT_DECODE, self._batches())

    def _batches(self) -> Iterator[Dict]:
        pending: List[Dict] = []
        seen = produced = 0
        for video in self.stream:
            seen += 1
            ex = self.sample_to_example(video)
            if ex is None:
                self._check_yields(seen, produced)
                continue
            produced += 1
            pending.append(ex)
            if len(pending) == self.batch_size:
                out = {k: np.stack([e[k] for e in pending]) for k in pending[0]}
                out["valid"] = np.ones(self.batch_size, bool)
                yield out
                pending = []

    def close(self) -> None:
        self.pool.shutdown(wait=True, cancel_futures=True)


class TripletLoader(VideoLoaderBase):
    """Middle-frame interpolation: cond=(first, last), target=middle
    (dataset_video.py:215-217)."""

    def sample_to_example(self, video):
        frames = video["frames"]
        n = len(frames)
        if n < 3:
            return None
        return self._gather(frames, [0, n - 1], n // 2)


class NextFrameLoader(VideoLoaderBase):
    """Next-frame prediction: cond=(random frame,), target=its successor
    (dataset_video_nextpredic.py:215-222)."""

    def sample_to_example(self, video):
        frames = video["frames"]
        n = len(frames)
        if n < 2:
            return None
        i = int(self.rng.integers(0, n - 1))
        return self._gather(frames, [i], i + 1)


class TwoFrameLoader(VideoLoaderBase):
    """2-frame conditioning: cond=(first, middle), target=last — the
    use2frames trainers reuse the triplet dataset with aliased fields."""

    def sample_to_example(self, video):
        frames = video["frames"]
        n = len(frames)
        if n < 3:
            return None
        return self._gather(frames, [0, n // 2], n - 1)


class SlidingWindowLoader(VideoLoaderBase):
    """Full-frames mode with host-side window building.

    Per video of T frames: window starts range(0, T - window_cond,
    window_stride); up to ``max_windows_per_video`` sampled without
    replacement (sorted); each window -> (cond frames s..s+window_cond-1,
    target s+window_cond).  Batch = train_batch_size videos' windows padded
    to the static size with valid=False rows.
    """

    def __init__(self, *a, window_cond: int = 3, window_stride: int = 1,
                 max_windows_per_video: int = 8, max_frames_per_video: int = 200,
                 **kw):
        super().__init__(*a, **kw)
        self.window_cond = window_cond
        self.window_stride = window_stride
        self.max_windows = max_windows_per_video
        self.max_frames = max_frames_per_video

    def video_windows(self, video) -> List[Dict]:
        frames = video["frames"][: self.max_frames]
        t = len(frames)
        if t < self.window_cond + 1:
            return []
        starts = list(range(0, t - self.window_cond, self.window_stride))
        if not starts:
            return []
        if self.max_windows and len(starts) > self.max_windows:
            starts = sorted(self.rng.choice(len(starts), self.max_windows, replace=False))
            starts = [int(s) * self.window_stride for s in starts]
        needed = sorted({s + o for s in starts for o in range(self.window_cond + 1)})
        if self.precomputed:
            from .precompute import load_feat
            try:
                feats = {f: load_feat(frames[f][1]) for f in needed}
            except Exception:   # an unreadable frame skips the video
                return []
            return [_assemble_precomputed([feats[s + o] for o in range(self.window_cond)],
                                          feats[s + self.window_cond]) for s in starts]
        arr_all = self._decode_frames(frames, needed)
        if arr_all is None:
            return []
        pos = {f: i for i, f in enumerate(needed)}
        return [{"cond": arr_all[[pos[s + o] for o in range(self.window_cond)]],
                 "target": arr_all[pos[s + self.window_cond]]} for s in starts]

    def _batches(self) -> Iterator[Dict]:
        static_bs = self.batch_size * self.max_windows
        windows: List[Dict] = []
        videos_in_batch = 0
        seen = produced = 0
        for video in self.stream:
            seen += 1
            ws = self.video_windows(video)
            if not ws:
                self._check_yields(seen, produced)
                continue
            produced += 1
            windows.extend(ws)
            videos_in_batch += 1
            if videos_in_batch == self.batch_size:
                yield self._emit(windows[:static_bs], static_bs)
                windows, videos_in_batch = [], 0

    def _emit(self, windows, static_bs) -> Dict:
        n = len(windows)
        out = {k: np.zeros((static_bs,) + np.shape(windows[0][k]),
                           np.asarray(windows[0][k]).dtype)
               for k in windows[0]}
        valid = np.zeros(static_bs, bool)
        for i, w in enumerate(windows):
            for k, v in w.items():
                out[k][i] = v
            valid[i] = True
        return {**out, "valid": valid,
                "avg_windows_per_video": n / max(1, self.batch_size), "bs_eff": n}


LOADERS = {
    "triplet": TripletLoader,
    "next": NextFrameLoader,
    "next2": TwoFrameLoader,
    "sliding": SlidingWindowLoader,
}


def loader(mode: str = "triplet", train_batch_size: int = 4, num_workers: int = 4,
           **kwargs):
    """Reference-compatible entry (dataset_video*.py ``loader``); ``mode``
    picks the conditioning family."""
    return LOADERS[mode](train_batch_size=train_batch_size, num_workers=num_workers, **kwargs)
