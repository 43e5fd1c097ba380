"""Per-row symmetric int8 quantization: K7.

Port of ``genhancer_tpu/core/pallas/rowquant.py``.  The kernel is
hand-written CUDA for Hopper in ``csrc/rowquant.cu``; this module holds its
wrapper, its plain PyTorch version and its launch counter.

``rowquant(x2, cs=None)``: x2 ``[T, C]`` bfloat16 or float32, optionally
times the per-column float32 scale ``cs`` ``[C]`` (the backward's
``g * ws``) -> (q int8 ``[T, C]``, s float32 ``[T]``) with
``s = max(max|x|, 1e-12) / 127`` and ``q = clip(round(x / s), -127, 127)``,
round half to even and IEEE division on both paths, so the kernel and the
plain version agree bit for bit.  Any T and C: the TPU's ``c % 128`` rule
has no counterpart, and neither has the ``GENHANCER_ROWQUANT`` opt-in —
``core.quant.quantize_activation_rows`` launches K7 for every CUDA tensor.

A CUDA tensor launches the kernel or raises; a CPU tensor takes the plain
version.  ``LAUNCHES`` counts kernel launches only.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from . import _build

LAUNCHES: Dict[str, int] = {"rowquant": 0}

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def div127(a: torch.Tensor) -> torch.Tensor:
    """``a / 127`` as an IEEE division: PyTorch's CUDA kernels turn a
    division by a host scalar into a product with its reciprocal, which is
    not the same float."""
    return a / torch.tensor(127.0, dtype=torch.float32, device=a.device)


def rowquant_ref(x2: torch.Tensor, cs: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K7 (``_kernel:37`` / ``_kernel_cs:45``)."""
    xf = x2.to(torch.float32)
    if cs is not None:
        xf = xf * cs.to(torch.float32)
    s = div127(torch.clamp_min(xf.abs().amax(dim=-1, keepdim=True), 1e-12))
    q = torch.clamp(torch.round(xf / s), -127, 127).to(torch.int8)
    return q, s[:, 0]


def _lib() -> ctypes.CDLL:
    lib = _build.load("rowquant")
    if not getattr(lib, "_genhancer_typed", False):
        lib.genhancer_rowquant.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 4
                                           + [ctypes.c_int64, ctypes.c_int, ctypes.c_void_p])
        lib.genhancer_rowquant.restype = ctypes.c_int
        lib._genhancer_typed = True
    return lib


def rowquant(x2: torch.Tensor, cs: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K7 on a [T, C] matrix; see the module docstring."""
    if x2.device.type == "cpu":
        return rowquant_ref(x2, cs)
    if not x2.is_cuda or x2.dim() != 2 or x2.dtype not in _DTYPES:
        raise ValueError(f"rowquant: x2 must be a 2-D float32/bfloat16 CUDA tensor, got "
                         f"{x2.dtype} {tuple(x2.shape)} on {x2.device}")
    t, c = x2.shape
    x2 = x2.contiguous()
    if cs is not None:
        cs = cs.to(torch.float32).contiguous()
        if cs.device != x2.device or cs.shape != (c,):
            raise ValueError(f"rowquant: cs must be float32 [{c}] on {x2.device}")
    q = torch.empty((t, c), dtype=torch.int8, device=x2.device)
    s = torch.empty((t,), dtype=torch.float32, device=x2.device)
    with torch.cuda.device(x2.device):
        rc = _lib().genhancer_rowquant(
            _DTYPES[x2.dtype], x2.data_ptr(), cs.data_ptr() if cs is not None else None,
            q.data_ptr(), s.data_ptr(), t, c, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"rowquant: CUDA kernel launch failed with cudaError {rc}")
    LAUNCHES["rowquant"] += 1
    return q, s
