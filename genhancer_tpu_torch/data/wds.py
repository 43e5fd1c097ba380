"""Streaming webdataset-format tar reader (the framework's own; the
``webdataset`` package is not a dependency).

Carried over from ``genhancer_tpu/data/wds.py`` (pure Python and numpy;
importing it through the JAX package's ``data/__init__`` would load JAX).

Replaces the reference's webdataset pipelines (``image_datasets/
dataset_cc3m.py:169-188``, ``dataset_video.py:288-328``,
``dataset_video_sliding_window.py:279-305``) with a deterministic
implementation:

  * shard expansion: glob patterns and ``{000..123}`` brace ranges;
  * per-host / per-worker shard splitting (``split_by_node`` /
    ``split_by_worker`` equivalents) by round-robin over the shard list;
  * sample grouping by webdataset key (path minus extension);
  * per-video-directory grouping for frame-per-sample video shards
    (``group_by_directory``, dataset_video.py:73-178) — deterministic, no
    watchdog timers needed because grouping is sequential over one shard;
  * bounded shuffle buffer with an explicit numpy RNG (seeded);
  * ``repeat`` for infinite epochs.

Everything is plain-Python iterators over file-like objects, so it also works
on in-memory tars in tests.
"""

from __future__ import annotations

import glob as globlib
import os
import re
import tarfile
from typing import Callable, Dict, Iterable, Iterator, List, Optional

import numpy as np


_BRACE_RE = re.compile(r"\{(\d+)\.\.(\d+)\}")


def expand_shards(pattern) -> List[str]:
    """Expand a shard spec: list, brace range, or glob (sorted)."""
    if isinstance(pattern, (list, tuple)):
        out: List[str] = []
        for p in pattern:
            out.extend(expand_shards(p))
        return out
    m = _BRACE_RE.search(pattern)
    if m:
        lo, hi = m.group(1), m.group(2)
        width = len(lo)
        return [pattern[:m.start()] + str(i).zfill(width) + pattern[m.end():]
                for i in range(int(lo), int(hi) + 1)]
    if any(c in pattern for c in "*?["):
        return sorted(globlib.glob(pattern))
    if os.path.isdir(pattern):
        return sorted(globlib.glob(os.path.join(pattern, "*.tar")))
    return [pattern]


def split_shards(shards: List[str], index: int, count: int) -> List[str]:
    """Round-robin split (split_by_node / split_by_worker equivalent)."""
    if count <= 1:
        return list(shards)
    return shards[index::count]


def iter_tar_samples(path_or_file) -> Iterator[Dict[str, bytes]]:
    """Yield webdataset samples {ext: bytes, '__key__': str} from one tar."""
    if isinstance(path_or_file, (str, os.PathLike)):
        tf = tarfile.open(path_or_file, "r|*")
    else:
        tf = tarfile.open(fileobj=path_or_file, mode="r|*")
    current_key: Optional[str] = None
    sample: Dict[str, bytes] = {}
    with tf:
        for member in tf:
            if not member.isfile():
                continue
            dirname, basename = os.path.split(member.name)
            if "." not in basename:
                continue
            stem, ext = basename.split(".", 1)
            base = f"{dirname}/{stem}" if dirname else stem
            if current_key is not None and base != current_key and sample:
                yield sample
                sample = {}
            current_key = base
            f = tf.extractfile(member)
            if f is not None:
                sample["__key__"] = base
                sample[ext.lower()] = f.read()
        if sample:
            yield sample


def group_by_directory(samples: Iterable[Dict[str, bytes]]
                       ) -> Iterator[Dict[str, object]]:
    """Aggregate frame-per-sample entries into one sample per video dir.

    Input keys look like ``vid123/frame_0``; output:
    ``{'__key__': 'vid123', 'frames': [(frame_key, jpg_bytes), ...],
       'txt': bytes|None}`` with frames sorted by numeric frame index.
    """
    current_dir: Optional[str] = None
    frames: List = []
    txt: Optional[bytes] = None

    def emit():
        frames.sort(key=lambda kv: _frame_index(kv[0]))
        return {"__key__": current_dir, "frames": list(frames), "txt": txt}

    for s in samples:
        key = s.get("__key__", "")
        d = key.rsplit("/", 1)[0] if "/" in key else key
        if current_dir is not None and d != current_dir and frames:
            yield emit()
            frames, txt = [], None
        current_dir = d
        jpg = (s.get("jpg") or s.get("jpeg") or s.get("png")
               or s.get("feat.npz"))   # a frame of the features cache (data.precompute)
        if jpg is not None:
            frames.append((key, jpg))
        if "txt" in s:
            txt = s["txt"]
    if frames:
        yield emit()


def _frame_index(key: str) -> int:
    m = re.search(r"(\d+)$", key)
    return int(m.group(1)) if m else 0


def shuffled(it: Iterator, buffer_size: int, rng: np.random.Generator) -> Iterator:
    """Bounded reservoir shuffle (webdataset .shuffle equivalent)."""
    if buffer_size <= 1:
        yield from it
        return
    buf: List = []
    for x in it:
        if len(buf) < buffer_size:
            buf.append(x)
            continue
        i = int(rng.integers(0, len(buf)))
        buf[i], x = x, buf[i]
        yield x
    rng.shuffle(buf)  # type: ignore[arg-type]
    yield from buf


class ShardStream:
    """Iterates samples over a shard list with node/worker splitting,
    shuffling, and optional infinite repeat."""

    def __init__(self, shards, *, node_index: int = 0, node_count: int = 1,
                 worker_index: int = 0, worker_count: int = 1,
                 shuffle_buffer: int = 0, seed: int = 0, repeat: bool = False,
                 sample_iter: Callable = iter_tar_samples,
                 group_videos: bool = False):
        every = expand_shards(shards)
        mine = split_shards(every, node_index, node_count)
        if not mine and every:
            # a rank without data would sit out while the others wait for
            # it in the step's collectives: fail here, at construction
            raise ValueError(f"rank {node_index} of {node_count} gets no shard: {len(every)} "
                             f"shard(s) for {node_count} ranks; write at least one per rank")
        self.shards = split_shards(mine, worker_index, worker_count)
        if not self.shards:
            raise ValueError(f"no shards after splitting: {shards}")
        self.shuffle_buffer = shuffle_buffer
        self.seed = seed
        self.repeat = repeat
        self.sample_iter = sample_iter
        self.group_videos = group_videos

    def __iter__(self) -> Iterator[Dict]:
        epoch = 0
        while True:
            rng = np.random.default_rng(self.seed + epoch)
            shards = list(self.shards)
            if self.shuffle_buffer:
                rng.shuffle(shards)

            def raw():
                for sh in shards:
                    try:
                        yield from self.sample_iter(sh)
                    except (tarfile.TarError, OSError) as e:  # warn_and_continue
                        import logging
                        logging.getLogger(__name__).warning(
                            "skipping unreadable shard %s: %s", sh, e)

            it: Iterator = raw()
            if self.group_videos:
                it = group_by_directory(it)
            if self.shuffle_buffer:
                it = shuffled(it, self.shuffle_buffer, rng)
            yield from it
            if not self.repeat:
                return
            epoch += 1
