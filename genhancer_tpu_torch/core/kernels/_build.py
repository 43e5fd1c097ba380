"""Build the CUDA kernels of this package at first use and load them.

Each ``csrc/<name>.cu`` has a plain C interface (device code shared between
sources lives in ``csrc/*.cuh``).  ``load(name)`` compiles it with ``nvcc``
for sm_90a into a shared library, loads it with ``ctypes`` and caches the
handle.  The library lands in ``csrc/_build/`` (git-ignored) under a name
keyed by a hash of the source, the headers and the flags, so an edited
source or header rebuilds and an unchanged one is reused within a checkout.
``load_all`` starts one ``nvcc`` per missing source, all at once.  Nothing
outside the package's sources and the CUDA toolkit is used.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = CSRC / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}
# name -> (build seconds, nvcc/ptxas report) of builds made by this process
BUILD_LOG: Dict[str, tuple] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): "
                       "the CUDA kernels are built from source at first use")


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` builds to: keyed by its source, every header
    in ``csrc/`` (the sources include them) and the flags."""
    src = b"".join([(CSRC / f"{name}.cu").read_bytes()]
                   + [h.read_bytes() for h in sorted(CSRC.glob("*.cuh"))])
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def load_all(names) -> Dict[str, ctypes.CDLL]:
    """The loaded libraries for ``csrc/<name>.cu`` of every name, building
    those that are missing with one ``nvcc`` each, all started together."""
    with _lock:
        todo = [n for n in dict.fromkeys(names)
                if n not in _loaded and not library_path(n).exists()]
        if todo:
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
        jobs = {}
        try:
            for name in todo:
                # build to a private name, then rename: a concurrent build
                # never loads a half-written library
                fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
                os.close(fd)
                proc = subprocess.Popen(
                    [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")],
                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                jobs[name] = (proc, tmp, time.perf_counter())
            for name, (proc, tmp, t0) in jobs.items():
                report, _ = proc.communicate()
                if proc.returncode != 0:
                    raise RuntimeError(f"nvcc failed for {name}.cu:\n{report}")
                os.replace(tmp, library_path(name))
                BUILD_LOG[name] = (time.perf_counter() - t0, report.strip())
        finally:
            for proc, tmp, _ in jobs.values():
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
                if os.path.exists(tmp):
                    os.unlink(tmp)
        for name in names:
            if name not in _loaded:
                _loaded[name] = ctypes.CDLL(str(library_path(name)))
        return {n: _loaded[n] for n in names}


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it if needed."""
    return load_all([name])[name]
