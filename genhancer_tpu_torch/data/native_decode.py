"""ctypes bindings for the native batched JPEG decoder (``native/ghdata.cc``).

Port of ``genhancer_tpu/data/native_decode.py``.  The library is the port's
own copy of the JAX package's ``ghdata.cc``, built at first use by
``core.kernels._build.load_host`` (the host C++ compiler with the JAX
Makefile's flags, linked against libjpeg) into the git-ignored
``csrc/_build/``.  Where it cannot be built (no compiler, no ``jpeglib.h``
or libjpeg) or ``GENHANCER_NATIVE_DECODE=0``, ``available()`` is false and
the loaders decode with PIL, exactly where the JAX loaders do.  Which
decoder a process uses is logged once, when it is first decided, and
``which()`` names it (with the reason when it is PIL).
"""

from __future__ import annotations

import ctypes
import logging
import math
import os
import threading
from pathlib import Path
from typing import Optional, Sequence, Tuple

import numpy as np

log = logging.getLogger(__name__)

SOURCE = Path(__file__).resolve().parent / "native" / "ghdata.cc"
_lock = threading.Lock()
_state = {"lib": None, "tried": False, "why": ""}


def _load() -> Optional[ctypes.CDLL]:
    with _lock:
        if _state["tried"]:
            return _state["lib"]
        _state["tried"] = True
        if os.environ.get("GENHANCER_NATIVE_DECODE", "1") == "0":
            _state["why"] = "GENHANCER_NATIVE_DECODE=0"
        else:
            from ..core.kernels._build import load_host
            try:
                lib = load_host(SOURCE, libs=("jpeg", "pthread"))
            except (RuntimeError, OSError) as e:
                _state["why"] = f"native build unavailable: {str(e).strip()[:300]}"
            else:
                lib.ghd_get_dims.argtypes = [
                    ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_size_t),
                    ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
                lib.ghd_get_dims.restype = None
                lib.ghd_decode_batch.argtypes = [
                    ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_size_t),
                    ctypes.c_int, ctypes.POINTER(ctypes.c_float), ctypes.c_int,
                    ctypes.c_int, ctypes.POINTER(ctypes.c_float),
                    ctypes.POINTER(ctypes.c_ubyte)]
                lib.ghd_decode_batch.restype = None
                _state["lib"] = lib
        log.info("JPEG decoder: %s", which())
        return _state["lib"]


def available() -> bool:
    return _load() is not None


def which() -> str:
    """``"native (ghdata.cc, libjpeg)"`` or ``"PIL (<reason>)"``: the
    decoder the loaders of this process use."""
    if not _state["tried"]:
        _load()
    if _state["lib"] is not None:
        return "native (ghdata.cc, libjpeg)"
    return f"PIL ({_state['why']})"


def _make_ptrs(blobs: Sequence[bytes]):
    n = len(blobs)
    arr = (ctypes.c_char_p * n)(*blobs)
    lens = (ctypes.c_size_t * n)(*[len(b) for b in blobs])
    return arr, lens


def _lib() -> ctypes.CDLL:
    lib = _load()
    if lib is None:
        raise RuntimeError(f"the native JPEG decoder is not available: {_state['why']}")
    return lib


def get_dims(blobs: Sequence[bytes]) -> np.ndarray:
    """[n, 2] (w, h); zeros where parsing failed."""
    lib = _lib()
    n = len(blobs)
    arr, lens = _make_ptrs(blobs)
    dims = np.zeros(n * 2, np.int32)
    lib.ghd_get_dims(arr, lens, n, dims.ctypes.data_as(ctypes.POINTER(ctypes.c_int)))
    return dims.reshape(n, 2)


def decode_batch(blobs: Sequence[bytes], rects: np.ndarray, size: int,
                 num_threads: int = 8) -> Tuple[np.ndarray, np.ndarray]:
    """Decode + crop(rects [n,4] source coords; w<=0 -> full) + resize.

    Returns (images [n, size, size, 3] float32 [0,1], ok [n] bool)."""
    lib = _lib()
    n = len(blobs)
    arr, lens = _make_ptrs(blobs)
    rects = np.ascontiguousarray(rects, np.float32)
    if rects.shape != (n, 4):
        raise ValueError(f"rects must be [{n}, 4], got {rects.shape}")
    out = np.empty((n, size, size, 3), np.float32)
    ok = np.zeros(n, np.uint8)
    lib.ghd_decode_batch(
        arr, lens, n, rects.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        size, num_threads, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        ok.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)))
    return out, ok.astype(bool)


def decode_batch_center(blobs: Sequence[bytes], size: int,
                        num_threads: int = 8) -> Tuple[np.ndarray, np.ndarray]:
    """Shorter-side resize + center crop (video/eval transform semantics)."""
    dims = get_dims(blobs)
    rects = np.zeros((len(blobs), 4), np.float32)
    for i, (w, h) in enumerate(dims):
        if w == 0 or h == 0:
            rects[i] = (0, 0, -1, -1)
            continue
        side = min(w, h)
        rects[i] = ((w - side) / 2.0, (h - side) / 2.0, side, side)
    return decode_batch(blobs, rects, size, num_threads)


def decode_batch_random_crop(blobs: Sequence[bytes], size: int,
                             rng: np.random.Generator,
                             scale: Tuple[float, float] = (0.9, 1.0),
                             ratio: Tuple[float, float] = (3 / 4, 4 / 3),
                             num_threads: int = 8
                             ) -> Tuple[np.ndarray, np.ndarray]:
    """RandomResizedCrop semantics (dataset_cc3m.py:91-121) with the crop
    geometry drawn from ``rng`` on the host, in the JAX loader's order, and
    the decode in native threads."""
    dims = get_dims(blobs)
    rects = np.zeros((len(blobs), 4), np.float32)
    for i, (w, h) in enumerate(dims):
        if w == 0 or h == 0:
            rects[i] = (0, 0, -1, -1)
            continue
        area = float(w * h)
        found = False
        for _ in range(10):
            target = area * rng.uniform(*scale)
            aspect = math.exp(rng.uniform(math.log(ratio[0]), math.log(ratio[1])))
            cw = int(round(math.sqrt(target * aspect)))
            ch = int(round(math.sqrt(target / aspect)))
            if 0 < cw <= w and 0 < ch <= h:
                x0 = int(rng.integers(0, w - cw + 1))
                y0 = int(rng.integers(0, h - ch + 1))
                rects[i] = (x0, y0, cw, ch)
                found = True
                break
        if not found:
            side = min(w, h)
            rects[i] = ((w - side) / 2.0, (h - side) / 2.0, side, side)
    return decode_batch(blobs, rects, size, num_threads)
