"""Offline video -> webdataset-shard converter (CPU-side, OpenCV).

Port of ``genhancer_tpu/data/convert/video_to_wds.py``: the same frames,
selections and tar layout, byte for byte.

Capability parity with the reference converters
(``/root/reference/Continuous/image_datasets/convert_webm_to_webdataset.py``
and ``convert_hdmb_to_webdataset.py``), which prepare Something-Something-V2
/ HMDB-style video folders for the video trainers:

  * frame extraction modes: ``fixed`` (every Nth frame), ``fps`` (target
    fps), ``fixed_time`` (ms interval), with ``max_frames`` cap;
  * ``triplet``: first + most-representative-middle + last, middle chosen by
    Farneback optical-flow motion magnitude or (inverse) SSIM;
  * ``frame_pair``: consecutive pairs, all or top-difference-percent by
    optical_flow / pixel_diff / ssim;
  * ``full_frames``: every sampled frame as ``frame_%06d.jpg`` (sliding-
    window training input);
  * tar shard writer with ``shard_size`` samples per shard, layout
    ``{sample_id}/frame_{i}.jpg + {sample_id}/frame_0.txt``.

SSIM is implemented locally (Gaussian-windowed, standard constants) since
scikit-image is not a dependency.
"""

from __future__ import annotations

import io
import logging
import os
import tarfile
from typing import List, Optional, Sequence, Tuple

import numpy as np

log = logging.getLogger(__name__)

try:
    import cv2
    _HAS_CV2 = True
except Exception:  # pragma: no cover
    cv2 = None
    _HAS_CV2 = False

VIDEO_EXTS = (".webm", ".avi", ".mp4", ".mov", ".mkv")


def ssim(a: np.ndarray, b: np.ndarray) -> float:
    """Grayscale SSIM, Gaussian window 11/1.5 (skimage-compatible constants)."""
    a = a.astype(np.float64)
    b = b.astype(np.float64)
    c1, c2 = (0.01 * 255) ** 2, (0.03 * 255) ** 2
    blur = lambda x: cv2.GaussianBlur(x, (11, 11), 1.5)
    mu_a, mu_b = blur(a), blur(b)
    var_a = blur(a * a) - mu_a ** 2
    var_b = blur(b * b) - mu_b ** 2
    cov = blur(a * b) - mu_a * mu_b
    num = (2 * mu_a * mu_b + c1) * (2 * cov + c2)
    den = (mu_a ** 2 + mu_b ** 2 + c1) * (var_a + var_b + c2)
    return float(np.mean(num / den))


def _gray(frame: np.ndarray, size: int = 128) -> np.ndarray:
    g = cv2.cvtColor(frame, cv2.COLOR_RGB2GRAY)
    return cv2.resize(g, (size, size), interpolation=cv2.INTER_AREA)


def optical_flow_magnitude(a: np.ndarray, b: np.ndarray) -> float:
    flow = cv2.calcOpticalFlowFarneback(_gray(a), _gray(b), None,
                                        0.5, 3, 15, 3, 5, 1.2, 0)
    return float(np.mean(np.linalg.norm(flow, axis=-1)))


def frame_difference(a: np.ndarray, b: np.ndarray, method: str) -> float:
    """Higher = more different."""
    if method == "optical_flow":
        return optical_flow_magnitude(a, b)
    if method == "pixel_diff":
        return float(np.mean(np.abs(a.astype(np.float32) - b.astype(np.float32))))
    if method == "ssim":
        return 1.0 - ssim(_gray(a), _gray(b))
    raise ValueError(method)


# ---------------------------------------------------------------------------
# extraction
# ---------------------------------------------------------------------------

def extract_frames(video_path: str, *, sample_mode: str = "fps",
                   sample_rate: int = 1, fps_target: float = 8.0,
                   time_interval: int = 1000,
                   max_frames: Optional[int] = None
                   ) -> Tuple[List[np.ndarray], List[float]]:
    """RGB frames + ms timestamps, sampled per mode (reference parity)."""
    cap = cv2.VideoCapture(video_path)
    if not cap.isOpened():
        return [], []
    frames, ts = [], []
    count = 0
    last_t = -float(time_interval)
    video_fps = cap.get(cv2.CAP_PROP_FPS)
    while True:
        ret, frame = cap.read()
        if not ret:
            break
        t = cap.get(cv2.CAP_PROP_POS_MSEC)
        if sample_mode == "fixed":
            take = count % max(1, sample_rate) == 0
        elif sample_mode == "fps" and video_fps and fps_target > 0:
            take = count % max(1, int(round(video_fps / fps_target))) == 0
        elif sample_mode == "fixed_time":
            take = t - last_t >= time_interval
        else:
            take = count % max(1, sample_rate) == 0
        if take:
            frames.append(cv2.cvtColor(frame, cv2.COLOR_BGR2RGB))
            ts.append(float(t))
            last_t = t
            if max_frames is not None and len(frames) >= max_frames:
                break
        count += 1
    cap.release()
    return frames, ts


# ---------------------------------------------------------------------------
# selection
# ---------------------------------------------------------------------------

def select_triplet(frames: Sequence[np.ndarray], method: str = "optical_flow"
                   ) -> Optional[Tuple[int, int, int]]:
    """(first, best-middle, last): the middle maximizes summed difference to
    the endpoints (motion-representative frame)."""
    n = len(frames)
    if n < 3:
        return None
    first, last = 0, n - 1
    best, best_score = n // 2, -1.0
    for i in range(1, n - 1):
        score = (frame_difference(frames[first], frames[i], method)
                 + frame_difference(frames[i], frames[last], method))
        if score > best_score:
            best, best_score = i, score
    return first, best, last


def select_pairs(frames: Sequence[np.ndarray], *, selection: str = "all",
                 difference_method: str = "optical_flow",
                 n_pairs: Optional[int] = None,
                 top_percent: float = 0.3) -> List[Tuple[int, int]]:
    n = len(frames)
    pairs = [(i, i + 1) for i in range(n - 1)]
    if selection == "all" or len(pairs) == 0:
        return pairs[:n_pairs] if n_pairs else pairs
    scores = [frame_difference(frames[i], frames[j], difference_method)
              for i, j in pairs]
    order = np.argsort(scores)[::-1]
    keep = n_pairs or max(1, int(round(len(pairs) * top_percent)))
    chosen = sorted(order[:keep])
    return [pairs[i] for i in chosen]


# ---------------------------------------------------------------------------
# shard writing
# ---------------------------------------------------------------------------

class ShardWriter:
    """Writes ``{output_dir}/shard-%06d.tar`` with ``shard_size`` samples."""

    def __init__(self, output_dir: str, shard_size: int = 1000,
                 prefix: str = "shard"):
        self.output_dir = output_dir
        self.shard_size = shard_size
        self.prefix = prefix
        self.shard_idx = 0
        self.count = 0
        self.tar: Optional[tarfile.TarFile] = None
        os.makedirs(output_dir, exist_ok=True)

    def _roll(self):
        if self.tar is not None:
            self.tar.close()
        path = os.path.join(self.output_dir,
                            f"{self.prefix}-{self.shard_idx:06d}.tar")
        self.tar = tarfile.open(path, "w")
        self.shard_idx += 1
        self.count = 0

    def add_sample(self, sample_id: str, frames: Sequence[np.ndarray],
                   text: str = "") -> None:
        if self.tar is None or self.count >= self.shard_size:
            self._roll()
        for i, frame in enumerate(frames):
            ok, buf = cv2.imencode(".jpg", cv2.cvtColor(frame, cv2.COLOR_RGB2BGR),
                                   [cv2.IMWRITE_JPEG_QUALITY, 90])
            if not ok:
                continue
            self._add(f"{sample_id}/frame_{i}.jpg", bytes(buf))
        self._add(f"{sample_id}/frame_0.txt", text.encode())
        self.count += 1

    def _add(self, name: str, data: bytes) -> None:
        info = tarfile.TarInfo(name)
        info.size = len(data)
        self.tar.addfile(info, io.BytesIO(data))

    def close(self):
        if self.tar is not None:
            self.tar.close()
            self.tar = None


# ---------------------------------------------------------------------------
# driver
# ---------------------------------------------------------------------------

def convert_videos(input_dir: str, output_dir: str, *,
                   dataset_type: str = "triplet",
                   sample_mode: str = "fps", sample_rate: int = 1,
                   fps_target: float = 8.0, time_interval: int = 1000,
                   max_frames: Optional[int] = None, shard_size: int = 1000,
                   method: str = "optical_flow",
                   pair_selection_method: str = "all",
                   pair_difference_method: str = "optical_flow",
                   n_pairs_per_video: Optional[int] = None,
                   top_percent: float = 0.3) -> int:
    """Returns number of samples written."""
    if not _HAS_CV2:
        raise RuntimeError("OpenCV is required for dataset conversion")
    videos = sorted(
        os.path.join(r, f)
        for r, _, files in os.walk(input_dir)
        for f in files if f.lower().endswith(VIDEO_EXTS))
    writer = ShardWriter(output_dir, shard_size)
    written = 0
    for vp in videos:
        frames, _ = extract_frames(vp, sample_mode=sample_mode,
                                   sample_rate=sample_rate,
                                   fps_target=fps_target,
                                   time_interval=time_interval,
                                   max_frames=max_frames)
        label = os.path.basename(os.path.dirname(vp))
        vid = os.path.splitext(os.path.basename(vp))[0]
        if dataset_type == "triplet":
            sel = select_triplet(frames, method)
            if sel is None:
                continue
            writer.add_sample(vid, [frames[i] for i in sel], label)
            written += 1
        elif dataset_type == "frame_pair":
            for pi, (i, j) in enumerate(select_pairs(
                    frames, selection=pair_selection_method,
                    difference_method=pair_difference_method,
                    n_pairs=n_pairs_per_video, top_percent=top_percent)):
                writer.add_sample(f"{vid}_pair{pi}", [frames[i], frames[j]], label)
                written += 1
        elif dataset_type == "full_frames":
            if len(frames) < 4:
                continue
            writer.add_sample(vid, frames, label)
            written += 1
        else:
            raise ValueError(dataset_type)
    writer.close()
    log.info("wrote %d samples from %d videos to %s", written, len(videos),
             output_dir)
    return written
