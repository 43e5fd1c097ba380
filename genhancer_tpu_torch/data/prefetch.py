"""Host -> device prefetch: overlap the input pipeline with device compute.

Port of ``genhancer_tpu/data/prefetch.py`` for one device (no mesh): a
background thread pulls host batches, pins each numpy array (on a CUDA
target) and copies it with ``non_blocking=True`` to the trainer's device
(other values, such as a batch's extras, pass through as they are), keeping a
queue of ``depth`` batches full so the train loop never blocks on JPEG
decode.  The copies go on the thread's current stream — CUDA's default
stream, where the train loop's kernels run too — so a batch is complete
before any kernel reads it.  With tracing on, each take records the
queue's depth and the wait (``input.queue_depth``, ``input.wait``), and the
thread's pin and copy of each batch the span ``input.h2d``.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator, Optional

import numpy as np
import torch

from .. import tracing

_SENTINEL = object()


class DevicePrefetcher:
    def __init__(self, host_iter, device, depth: int = 2):
        self.host_iter = iter(host_iter)
        self.device = torch.device(device)
        self.queue: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._err: Optional[BaseException] = None
        self.thread = threading.Thread(target=self._worker, daemon=True)
        self.thread.start()

    def _place(self, batch):
        out = {}
        with tracing.span(tracing.INPUT_H2D):
            for k, v in batch.items():
                if not isinstance(v, np.ndarray):
                    out[k] = v
                    continue
                t = torch.from_numpy(np.ascontiguousarray(v))
                if self.device.type == "cuda":
                    t = t.pin_memory().to(self.device, non_blocking=True)
                out[k] = t
        return out

    def _put(self, item) -> bool:
        while not self._stop.is_set():
            try:
                self.queue.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _worker(self):
        try:
            for batch in self.host_iter:
                if not self._put(self._place(batch)):
                    return
        except BaseException as e:  # surfaced on the next __next__
            self._err = e
        finally:
            self._put(_SENTINEL)

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        tracing.count(tracing.INPUT_QUEUE_DEPTH, self.queue.qsize())
        with tracing.span(tracing.INPUT_WAIT):
            item = self.queue.get()
        if item is _SENTINEL:
            if self._err is not None:
                raise self._err
            raise StopIteration
        return item

    def close(self) -> None:
        """Stop the worker thread and wait for it."""
        self._stop.set()
        while self.thread.is_alive():
            try:
                self.queue.get(timeout=0.1)
            except queue.Empty:
                pass
        self.thread.join()
