"""Build the CUDA kernels of this package at first use and load them.

Each ``csrc/<name>.cu`` has a plain C interface (device code shared between
sources lives in ``csrc/*.cuh``).  ``load(name)`` compiles it with ``nvcc``
for sm_90a into a shared library, loads it with ``ctypes`` and caches the
handle.  The library lands in ``csrc/_build/`` (git-ignored) under a name
keyed by a hash of the source, the headers and the flags, so an edited
source or header rebuilds and an unchanged one is reused within a checkout.
``load_all`` starts one ``nvcc`` per missing source, all at once.  Nothing
outside the package's sources and the CUDA toolkit is used.

``load_host`` builds a host C++ source of the package the same way, with
the host compiler (the native JPEG decoder, ``data/native/ghdata.cc``,
linked against the system's libjpeg).
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
from typing import Dict, Sequence

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = CSRC / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# the JAX package's data/native/Makefile flags, so both decoders compile alike
HOST_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-Wall", "-march=native", "-shared")

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


def _host_compiler() -> str:
    for cand in (os.environ.get("CXX"), "g++", "c++"):
        if cand and shutil.which(cand):
            return shutil.which(cand)
    raise RuntimeError("no host C++ compiler ($CXX, g++, c++) on PATH")


def load_host(source: Path, libs: Sequence[str] = ()) -> ctypes.CDLL:
    """The loaded library for the host C++ file ``source``, built at first
    use with ``HOST_FLAGS`` and ``-l<lib>`` for each of ``libs`` into
    ``BUILD_DIR``, keyed by a hash of the source, the flags and the libs.
    Raises ``RuntimeError`` with the compiler's report when the build fails
    (a missing header or library, or no compiler)."""
    source = Path(source)
    link = tuple(f"-l{lib}" for lib in libs)
    digest = hashlib.sha256(source.read_bytes()
                            + " ".join(HOST_FLAGS + link).encode()).hexdigest()[:16]
    path = BUILD_DIR / f"lib{source.stem}-{digest}.so"
    key = str(path)
    with _lock:
        if key in _loaded:
            return _loaded[key]
        if not path.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            t0 = time.perf_counter()
            try:
                proc = subprocess.run([_host_compiler(), *HOST_FLAGS, str(source), "-o", tmp,
                                       *link], capture_output=True, text=True, timeout=300)
                if proc.returncode != 0:
                    raise RuntimeError(f"the host build of {source.name} failed:\n"
                                       f"{proc.stdout}{proc.stderr}")
                os.replace(tmp, path)
            finally:
                if os.path.exists(tmp):
                    os.unlink(tmp)
            BUILD_LOG[source.stem] = (time.perf_counter() - t0,
                                      (proc.stdout + proc.stderr).strip())
        _loaded[key] = ctypes.CDLL(str(path))
        return _loaded[key]
