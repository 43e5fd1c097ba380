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
K8 exactly where the JAX package takes its kernel, and the kernel takes
exactly those O and I.

``int8_dw_with_codes`` is K8 returning its quantization workspace as well
(``Codes``: the codes K-major, t contiguous, zero past T, and the scales),
so that the quantization pass can be held to ``block_codes_ref``.

A CUDA tensor launches the kernel or raises; a CPU tensor takes the plain
version.  ``LAUNCHES`` counts kernel launches only.
"""

from __future__ import annotations

import ctypes
from typing import Dict, NamedTuple

import torch

from . import _build
from .int8_mm import int_mm
from .rowquant import div127

LAUNCHES: Dict[str, int] = {"int8_dw": 0}

BLOCK_T = 512
CHUNK_T = 128   # the workspace's t is padded to whole boxes of 128 codes
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


class Codes(NamedTuple):
    """K8's quantization workspace: ``gq`` int8 [O, Tp] and ``xq`` int8
    [I, Tp] (t contiguous, Tp = T rounded up to ``CHUNK_T``, zero past T),
    ``sg`` float32 [nT, O] and ``sx`` float32 [nT, I]."""
    gq: torch.Tensor
    sg: torch.Tensor
    xq: torch.Tensor
    sx: torch.Tensor


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


def block_codes_ref(a: torch.Tensor):
    """Plain version of K8's quantization pass for one operand a [T, C]:
    (codes int8 [C, Tp], t contiguous and zero past T; scales float32
    [nT, C])."""
    t, c = a.shape
    codes = torch.zeros((c, -(-t // CHUNK_T) * CHUNK_T), dtype=torch.int8, device=a.device)
    scales = []
    for t0 in range(0, t, BLOCK_T):
        q, s = _quantize_block(a[t0:t0 + BLOCK_T])
        codes[:, t0:t0 + q.shape[0]] = q.t()
        scales.append(s)
    return codes, torch.stack(scales)


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
    """K8; see the module docstring."""
    if g2.device.type == "cpu":
        return int8_dw_ref(g2, x2, out_dtype)
    return _launch(g2, x2, out_dtype)[0]


def int8_dw_with_codes(g2: torch.Tensor, x2: torch.Tensor, out_dtype=torch.float32):
    """K8 and its quantization workspace: (dW, ``Codes``)."""
    if g2.device.type == "cpu":
        return (int8_dw_ref(g2, x2, out_dtype),
                Codes(*block_codes_ref(g2), *block_codes_ref(x2)))
    return _launch(g2, x2, out_dtype)


def _launch(g2, x2, out_dtype):
    t, o = g2.shape
    i = x2.shape[1]
    if (not (g2.is_cuda and x2.device == g2.device) or x2.shape[0] != t
            or g2.dtype not in _DTYPES or x2.dtype != g2.dtype or out_dtype not in _DTYPES):
        raise ValueError(f"int8_dw: g2 [T, O] and x2 [T, I] must be float32/bfloat16 on one "
                         f"CUDA device, got {g2.dtype} {tuple(g2.shape)}, {x2.dtype} "
                         f"{tuple(x2.shape)}, out {out_dtype}")
    if t == 0 or o % 128 or i % 128:
        raise ValueError(f"int8_dw: T > 0 and O, I multiples of 128 needed, got {t}, {o}, {i}")
    g2, x2 = g2.contiguous(), x2.contiguous()
    if g2.data_ptr() % 16 or x2.data_ptr() % 16:
        raise ValueError("int8_dw: g2 and x2 must start on 16-byte boundaries (the "
                         "quantization pass reads 16 bytes at a time)")
    n_t, tp = -(-t // BLOCK_T), -(-t // CHUNK_T) * CHUNK_T
    dev = g2.device
    codes = Codes(torch.empty((o, tp), dtype=torch.int8, device=dev),
                  torch.empty((n_t, o), dtype=torch.float32, device=dev),
                  torch.empty((i, tp), dtype=torch.int8, device=dev),
                  torch.empty((n_t, i), dtype=torch.float32, device=dev))
    dw = torch.empty((o, i), dtype=out_dtype, device=dev)
    with torch.cuda.device(dev):
        rc = _lib().genhancer_int8_dw(
            _DTYPES[g2.dtype], _DTYPES[out_dtype], g2.data_ptr(), x2.data_ptr(), t, o, i,
            codes.gq.data_ptr(), codes.sg.data_ptr(), codes.xq.data_ptr(), codes.sx.data_ptr(),
            dw.data_ptr(), torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"int8_dw: CUDA kernel launch failed with error {rc} (cudaError, "
                           "or 10000 + CUresult where a tensor map did not encode)")
    LAUNCHES["int8_dw"] += 1
    return dw, codes
