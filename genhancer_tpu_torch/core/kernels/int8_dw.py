"""Int8 weight gradient with per-(t-block, column) quantization: K8.

Port of ``genhancer_tpu/core/pallas/int8_dw.py``.  The kernel is
hand-written CUDA for Hopper in ``csrc/int8_dw.cu``; this module holds its
wrapper, its plain PyTorch version and its launch counter.

``int8_dw(g2, x2, out_dtype)``: g2 ``[T, O]``, x2 ``[T, I]`` (bfloat16 or
float32) -> dW ``[O, I] = sum_t g[t, o] x[t, i]`` in ``out_dtype``.  Each
512-row block of t is quantized per column (``s = max(max|.|, 1e-12) / 127``,
``q = clip(round(. / s), -127, 127)``), the int8 products are summed exactly
in int32, and the blocks' partials are added in t order in float32 as
``acc += (p * sg[o]) * sx[i]`` — the TPU kernel's association
(``_dw_kernel:76``).  The 512-row blocks are part of the result; there is no
counterpart of ``GENHANCER_DW_BLOCK_*``.  ``dw_supported`` is the TPU
package's rule (O and I multiples of 128, T >= 8): ``core.quant._dw`` takes
K8 exactly where the JAX package takes its kernel.

A CUDA tensor launches the kernel or raises; a CPU tensor takes the plain
version.  ``LAUNCHES`` counts kernel launches only.
"""

from __future__ import annotations

import ctypes
from typing import Dict

import torch

from . import _build
from .int8_mm import int_mm
from .rowquant import div127

LAUNCHES: Dict[str, int] = {"int8_dw": 0}

BLOCK_T = 512
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def dw_supported(t: int, o: int, i: int) -> bool:
    """``int8_dw.dw_supported:108``: O and I tile to 128 lanes, T >= 8."""
    return o % 128 == 0 and i % 128 == 0 and t >= 8


def _quantize_block(a: torch.Tensor):
    """Per-column int8 of one [rows, C] block -> (int8, float32 [C])."""
    af = a.to(torch.float32)
    s = div127(torch.clamp_min(af.abs().amax(dim=0), 1e-12))
    return torch.clamp(torch.round(af / s), -127, 127).to(torch.int8), s


def int8_dw_ref(g2: torch.Tensor, x2: torch.Tensor, out_dtype=torch.float32) -> torch.Tensor:
    """Plain version of K8 (``_dw_kernel:53``)."""
    t = g2.shape[0]
    acc = None
    for t0 in range(0, t, BLOCK_T):
        gq, sg = _quantize_block(g2[t0:t0 + BLOCK_T])
        xq, sx = _quantize_block(x2[t0:t0 + BLOCK_T])
        part = (int_mm(gq.t(), xq).to(torch.float32) * sg[:, None]) * sx[None, :]
        acc = part if acc is None else acc + part
    return acc.to(out_dtype)


def _lib() -> ctypes.CDLL:
    lib = _build.load("int8_dw")
    if not getattr(lib, "_genhancer_typed", False):
        lib.genhancer_int8_dw.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 2
                                          + [ctypes.c_int64, ctypes.c_int, ctypes.c_int]
                                          + [ctypes.c_void_p] * 6)
        lib.genhancer_int8_dw.restype = ctypes.c_int
        lib._genhancer_typed = True
    return lib


def int8_dw(g2: torch.Tensor, x2: torch.Tensor, out_dtype=torch.float32) -> torch.Tensor:
    """K8; see the module docstring.  The kernel needs O and I multiples of
    64 (``dw_supported`` asks for 128)."""
    if g2.device.type == "cpu":
        return int8_dw_ref(g2, x2, out_dtype)
    t, o = g2.shape
    i = x2.shape[1]
    if (not (g2.is_cuda and x2.device == g2.device) or x2.shape[0] != t
            or g2.dtype not in _DTYPES or x2.dtype != g2.dtype or out_dtype not in _DTYPES):
        raise ValueError(f"int8_dw: g2 [T, O] and x2 [T, I] must be float32/bfloat16 on one "
                         f"CUDA device, got {g2.dtype} {tuple(g2.shape)}, {x2.dtype} "
                         f"{tuple(x2.shape)}, out {out_dtype}")
    if t == 0 or o % 64 or i % 64:
        raise ValueError(f"int8_dw: T > 0 and O, I multiples of 64 needed, got {t}, {o}, {i}")
    g2, x2 = g2.contiguous(), x2.contiguous()
    n_t = -(-t // BLOCK_T)
    dev = g2.device
    gq = torch.empty((n_t * BLOCK_T, o), dtype=torch.int8, device=dev)
    xq = torch.empty((n_t * BLOCK_T, i), dtype=torch.int8, device=dev)
    sg = torch.empty((n_t, o), dtype=torch.float32, device=dev)
    sx = torch.empty((n_t, i), dtype=torch.float32, device=dev)
    dw = torch.empty((o, i), dtype=out_dtype, device=dev)
    with torch.cuda.device(dev):
        rc = _lib().genhancer_int8_dw(
            _DTYPES[g2.dtype], _DTYPES[out_dtype], g2.data_ptr(), x2.data_ptr(), t, o, i,
            gq.data_ptr(), sg.data_ptr(), xq.data_ptr(), sx.data_ptr(), dw.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"int8_dw: CUDA kernel launch failed with cudaError {rc}")
    LAUNCHES["int8_dw"] += 1
    return dw
