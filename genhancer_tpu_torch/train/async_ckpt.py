"""Asynchronous checkpoint writing: the step loop pays for the device-to-host
copy, a background thread for the serialization and the disk write.

Port of ``genhancer_tpu/train/async_ckpt.py`` (``AsyncCheckpointer:90-132``).
Data parallel, the trainer gathers the ZeRO-1 moments on every rank first
(``checkpoint.optimizer_state_dict``, JAX's ``gather_sharded``) and rank 0
alone hands the tree to ``save``.  The snapshot is taken on the calling thread before
``save`` returns, and it must be a copy: the optimizers (the AdamW chain,
K3, K4, K6) update parameters and moments in place, so a state dict holds
references that the next step overwrites.  ``host_snapshot`` starts a
non-blocking copy of every CUDA tensor into pinned host memory (one buffer
per tensor, kept and reused by the next save of the same shape), clones
every CPU tensor, and synchronizes once; the copies are ordered on the
stream before any later step's kernels, so the snapshot holds the saved
step whatever runs next.

  * at most one save is in flight: a new save first drains the previous one
    (so one host snapshot is alive at a time, and the pinned buffers it
    used are free again);
  * an exception in the writer surfaces on the next ``save``/``wait``;
  * ``wait``/``close`` drain; the trainer drains before ``train()`` returns
    and on its SIGTERM stop, so every file exists when it returns.

``enabled=False`` (``async_checkpointing: false``) runs ``write_fn`` on the
live tensors inline; the files are the same bytes.
"""

from __future__ import annotations

import logging
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Callable, Dict, List, Optional

import torch

log = logging.getLogger("genhancer_tpu_torch.trainer")


def host_snapshot(tree, pinned: Optional[Dict[tuple, torch.Tensor]] = None, _path=()):
    """A copy of ``tree`` (nested dicts and lists of tensors; other leaves
    pass through) with every tensor on the host: CUDA tensors by
    non-blocking copies into pinned buffers (taken from and added to
    ``pinned`` by path where one is given), CPU tensors cloned.  The caller
    synchronizes (``snapshot``)."""
    if isinstance(tree, dict):
        return {k: host_snapshot(v, pinned, _path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(host_snapshot(v, pinned, _path + (i,)) for i, v in enumerate(tree))
    if not isinstance(tree, torch.Tensor):
        return tree
    t = tree.detach()
    if not t.is_cuda:
        return t.clone()
    buf = None if pinned is None else pinned.get(_path)
    if buf is None or buf.shape != t.shape or buf.dtype != t.dtype:
        buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        if pinned is not None:
            pinned[_path] = buf
    buf.copy_(t, non_blocking=True)
    return buf


def snapshot(tree, pinned: Optional[Dict[tuple, torch.Tensor]] = None):
    """``host_snapshot`` of ``tree``, complete when it returns."""
    out = host_snapshot(tree, pinned)
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()
    return out


class AsyncCheckpointer:
    """Run checkpoint-write closures on a background thread.

    ``save(tree, write_fn)`` snapshots ``tree`` to host memory on the calling
    thread and schedules ``write_fn(snapshot)`` on the writer thread.
    ``stalls`` holds, per save, the seconds it held its caller (the drain of
    the previous save and the snapshot), ``writes`` the writer's seconds per
    completed write."""

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self._exec: Optional[ThreadPoolExecutor] = None
        self._inflight: Optional[Future] = None
        self._lock = threading.Lock()
        self._pinned: Dict[tuple, torch.Tensor] = {}
        self.stalls: List[float] = []
        self.writes: List[float] = []

    def save(self, tree, write_fn: Callable[[object], None]) -> None:
        t0 = time.perf_counter()
        if not self.enabled:
            write_fn(tree)
            self.stalls.append(time.perf_counter() - t0)
            self.writes.append(self.stalls[-1])
            return
        with self._lock:
            if self._exec is None:
                self._exec = ThreadPoolExecutor(max_workers=1,
                                                thread_name_prefix="ckpt-writer")
            self._drain_locked()
            host = snapshot(tree, self._pinned)
            self.stalls.append(time.perf_counter() - t0)
            self._inflight = self._exec.submit(self._write, write_fn, host)

    def _write(self, write_fn, host) -> None:
        t0 = time.perf_counter()
        write_fn(host)
        self.writes.append(time.perf_counter() - t0)
        log.info("checkpoint writer: %.2f s", self.writes[-1])

    def wait(self) -> None:
        """Block until the in-flight save (if any) is written."""
        with self._lock:
            self._drain_locked()

    def close(self) -> None:
        """Drain, stop the writer thread and release the pinned buffers to
        PyTorch's pinned-memory cache (where a later snapshot of the same
        sizes finds them: pinning host memory is the slow part of a first
        save); a later ``save`` starts again."""
        try:
            self.wait()
        finally:
            with self._lock:
                if self._exec is not None:
                    self._exec.shutdown(wait=True)
                    self._exec = None
                self._pinned.clear()

    def _drain_locked(self) -> None:
        if self._inflight is not None:
            fut, self._inflight = self._inflight, None
            fut.result()        # re-raises the writer's exception here
