"""Per-row symmetric int8 quantization: K7.

Port of ``genhancer_tpu/core/pallas/rowquant.py``.  The kernel is
hand-written CUDA for Hopper in ``csrc/rowquant.cu``; this module holds its
wrapper, its tiling rule, its plain PyTorch version and its launch counter.

``rowquant(x2, cs=None)``: x2 ``[T, C]`` bfloat16 or float32, optionally
times the per-column float32 scale ``cs`` ``[C]`` (the backward's
``g * ws``) -> (q int8 ``[T, C]``, s float32 ``[T]``) with
``s = max(max|x|, 1e-12) / 127`` and ``q = clip(round(x / s), -127, 127)``,
round half to even and IEEE division on both paths, so the kernel and the
plain version agree bit for bit.  Any T and C: the TPU's ``c % 128`` rule
has no counterpart, and neither has the ``GENHANCER_ROWQUANT`` opt-in —
``core.quant.quantize_activation_rows`` launches K7 for every CUDA tensor.

``rowquant_tiling`` picks the kernel's body from (T, C, element size,
alignment) on the host; it is pure, so the CPU tests check that it covers
every row and column of the int8 paths' shapes.

A CUDA tensor launches the kernel (one launch per call, whatever the body)
or raises; a CPU tensor takes the plain version.  ``LAUNCHES`` counts kernel
launches only.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from . import _build

LAUNCHES: Dict[str, int] = {"rowquant": 0}

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ITEMSIZE = {torch.float32: 4, torch.bfloat16: 2}

SMS = 132              # streaming multiprocessors of the H100 SXM
UNIT = 8               # elements a thread loads and codes together (one 8-byte store)
WARP_UNITS = (1, 2, 3, 4)               # units per lane the warp body is built for
BLOCK_UNITS = (3, 4, 6, 8, 12, 16)      # units per thread the block body is built for
MAX_VECTORS = 16       # 16-byte vectors a thread holds: 16 bfloat16 units, 8 float32
WARP_ROWS = 8          # most rows per block of the warp body
BLOCK_THREADS = 512    # most threads per block of the block body
SCALAR_THREADS = 256
BODIES = ("warp", "block", "scalar")   # csrc/rowquant.cu Body


class Tiling(NamedTuple):
    """How K7 runs a [T, C] call: ``body`` (``BODIES``), rows per block
    (warp body), threads per block, blocks per row (block body: a cluster
    where > 1) and units of 8 elements per thread (0: the scalar body)."""
    body: str
    rows_per_block: int
    threads: int
    cluster: int
    units: int


def rowquant_tiling(t: int, c: int, itemsize: int, aligned: bool) -> Tiling:
    """K7's body for T rows of C elements of ``itemsize`` bytes; ``aligned``:
    x's (and cs's) base is 16-byte aligned.

    * a misaligned base or C not a multiple of 8: the scalar body;
    * rows of at most 32 x 4 units (1024 columns): one warp per row, up to
      8 rows per block, fewer where T would leave SMs idle;
    * wider rows: one block per row, or, where T is below twice the SM
      count, a cluster of up to 8 blocks per row (each still holding at
      least 32 x 3 units), so that a few wide rows spread over the card;
      3 or 4 units per thread up to 512 threads, more above (short work per
      thread: see ``csrc/rowquant.cu``);
    * rows wider than that (bfloat16 beyond 65536 columns, float32 beyond
      32768 at T >= 264): the scalar body, which re-reads x.
    """
    scalar = Tiling("scalar", 1, SCALAR_THREADS, 1, 0)
    if not aligned or c % UNIT:
        return scalar
    n = c // UNIT
    if n <= 32 * WARP_UNITS[-1]:
        rows = max(1, min(WARP_ROWS, t // (2 * SMS)))
        return Tiling("warp", rows, 32 * rows, 1, -(-n // 32))
    cluster = 1
    while cluster < 8 and t * cluster < 2 * SMS and n // (2 * cluster) >= 32 * BLOCK_UNITS[0]:
        cluster *= 2
    per_block = -(-n // cluster)
    cap = MAX_VECTORS * 2 // itemsize
    need = max(BLOCK_UNITS[0], -(-per_block // BLOCK_THREADS))
    units = next((u for u in BLOCK_UNITS if need <= u <= cap), None)
    if units is None:
        return scalar
    return Tiling("block", 1, (-(-per_block // units) + 31) // 32 * 32, cluster, units)


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


@functools.lru_cache(maxsize=None)
def _entry():
    """The typed C entry point, built and loaded at first use."""
    fn = _build.load("rowquant").genhancer_rowquant
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int64]
                   + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=1024)
def _launch_args(t: int, c: int, dtype: torch.dtype, aligned: bool) -> Tuple[int, int, int, int]:
    """(body number, threads, cluster, units) of ``rowquant_tiling``, cached:
    the int8 paths call K7 at a few dozen shapes."""
    tl = rowquant_tiling(t, c, _ITEMSIZE[dtype], aligned)
    return BODIES.index(tl.body), tl.threads, tl.cluster, tl.units


def rowquant(x2: torch.Tensor, cs: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K7 on a [T, C] matrix; see the module docstring.  The host work per
    call is kept small (the int8 steps are partly host-bound): each tensor
    attribute read once, no copy, cast or device switch where it would be a
    no-op, the tiling cached, the raw current stream."""
    if not x2.is_cuda:
        if x2.device.type == "cpu":
            return rowquant_ref(x2, cs)
        raise ValueError(f"rowquant: x2 must be on the CPU or a CUDA device, got {x2.device}")
    dtype, shape = x2.dtype, x2.shape
    if len(shape) != 2 or dtype not in _DTYPES:
        raise ValueError(f"rowquant: x2 must be a 2-D float32/bfloat16 CUDA tensor, got "
                         f"{dtype} {tuple(shape)}")
    t, c = shape
    if not x2.is_contiguous():
        x2 = x2.contiguous()
    dev, x_ptr = x2.get_device(), x2.data_ptr()
    cs_ptr = None
    if cs is not None:
        if cs.dtype != torch.float32 or not cs.is_contiguous():
            cs = cs.to(torch.float32).contiguous()
        if cs.get_device() != dev or cs.shape != (c,):
            raise ValueError(f"rowquant: cs must be float32 [{c}] on {x2.device}")
        cs_ptr = cs.data_ptr()
    q = x2.new_empty((t, c), dtype=torch.int8)
    s = x2.new_empty((t,), dtype=torch.float32)
    aligned = x_ptr % 16 == 0 and (cs_ptr is None or cs_ptr % 16 == 0)
    args = (_DTYPES[dtype], x_ptr, cs_ptr, q.data_ptr(), s.data_ptr(), t, c,
            *_launch_args(t, c, dtype, aligned))
    if dev == torch._C._cuda_getDevice():
        rc = _entry()(*args, torch._C._cuda_getCurrentRawStream(dev))
    else:
        with torch.cuda.device(dev):
            rc = _entry()(*args, torch._C._cuda_getCurrentRawStream(dev))
    if rc != 0:
        raise RuntimeError(f"rowquant: CUDA kernel launch failed with cudaError {rc} "
                           f"({rowquant_tiling(t, c, _ITEMSIZE[dtype], aligned)} for "
                           f"[{t}, {c}] {dtype})")
    LAUNCHES["rowquant"] += 1
    return q, s
