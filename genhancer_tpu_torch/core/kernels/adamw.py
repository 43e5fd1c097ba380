"""Fused clip + AdamW update: K3.

Port of ``genhancer_tpu/core/pallas/adamw.py`` (the dense-moment,
no-quant path).  The kernel is hand-written CUDA for Hopper in
``csrc/adamw.cu``; this module holds its wrapper, its plain PyTorch version
and its launch counter, plus the tree-level ``fused_adamw_apply``.

* ``fused_adamw_leaf(p, m, v, g, scalars, ...)`` — K3 on one leaf, in
  place; any shape (the TPU's (8, 128) tile rule does not apply to a flat
  elementwise kernel);
* ``fused_adamw_leaf_ref`` — ``_update_leaf_xla:328`` (returns new tensors);
* ``fused_adamw_apply(params, mu, nu, grads, count, schedule, ...)`` —
  ``fused_adamw_apply:338`` over flat ``{path: tensor}`` dicts, in place.

The port updates p, m and v in place, where the JAX package returns new
arrays: the kernel's only traffic is the one read and one write of each.

A CUDA tensor launches the kernel or raises; a CPU tensor takes the plain
version.  ``LAUNCHES`` counts kernel launches only.
"""

from __future__ import annotations

import ctypes
from typing import Callable, Dict

import numpy as np
import torch

from ..nn import as_dtype_scalar
from . import _build

LAUNCHES: Dict[str, int] = {"fused_adamw": 0}

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def global_norm(grads: Dict[str, torch.Tensor]) -> torch.Tensor:
    """``optax.global_norm`` on a flat dict: leaves in sorted key order (the
    order ``jax.tree.leaves`` walks a dict), each leaf's sum of squares
    accumulated in float32 and rounded to the leaf's dtype, the per-leaf
    sums added with type promotion, then the square root."""
    total = 0
    for key in sorted(grads):
        x = grads[key]
        total = total + (x * x).sum(dtype=torch.float32).to(x.dtype)
    return torch.sqrt(total)


def fused_adamw_leaf_ref(p, m, v, g, scalars, b1, b2, eps, wd):
    """Plain version of K3, ``_update_leaf_xla:328``: f32 math, results in
    the storage dtypes.  Returns (p, m, v)."""
    f32 = torch.float32
    scale, lr, inv_bc1, inv_bc2 = (scalars[0], scalars[1], scalars[2], scalars[3])
    gf = g.to(f32) * scale
    mf = b1 * m.to(f32) + (1.0 - b1) * gf
    vf = b2 * v.to(f32) + (1.0 - b2) * gf * gf
    pf = p.to(f32)
    pf = pf - lr * ((mf * inv_bc1) / (torch.sqrt(vf * inv_bc2) + eps) + wd * pf)
    return pf.to(p.dtype), mf.to(m.dtype), vf.to(v.dtype)


def ulp_distance(got: torch.Tensor, want: torch.Tensor) -> torch.Tensor:
    """|got - want| in units in the last place of ``want``'s dtype at
    ``want`` (float32 result): how the kernel is held to its plain version."""
    finfo = torch.finfo(want.dtype)
    _, exp = torch.frexp(want.to(torch.float32))
    ulp = torch.ldexp(torch.full_like(exp, finfo.eps, dtype=torch.float32), exp - 1)
    return ((got.to(torch.float32) - want.to(torch.float32)).abs()
            / ulp.clamp_min(finfo.tiny))


def _lib() -> ctypes.CDLL:
    lib = _build.load("adamw")
    if not getattr(lib, "_genhancer_typed", False):
        lib.genhancer_fused_adamw.argtypes = (
            [ctypes.c_int] * 2 + [ctypes.c_void_p] * 5 + [ctypes.c_int64]
            + [ctypes.c_float] * 6 + [ctypes.c_void_p])
        lib.genhancer_fused_adamw.restype = ctypes.c_int
        lib._genhancer_typed = True
    return lib


def _check(p, m, v, g, scalars) -> None:
    if not (p.is_cuda and all(t.device == p.device for t in (m, v, g, scalars))):
        raise ValueError("fused_adamw: p, m, v, g and scalars must be on one CUDA device, "
                         f"got {p.device}, {m.device}, {v.device}, {g.device}, "
                         f"{scalars.device}")
    if p.dtype not in _DTYPES or m.dtype != p.dtype or v.dtype != p.dtype:
        raise TypeError(f"fused_adamw: p, m, v must share dtype float32 or bfloat16, got "
                        f"{p.dtype}, {m.dtype}, {v.dtype}")
    if g.dtype not in _DTYPES:
        raise TypeError(f"fused_adamw: g must be float32 or bfloat16, got {g.dtype}")
    if not (m.shape == v.shape == g.shape == p.shape):
        raise ValueError("fused_adamw: p, m, v, g must share one shape")
    if not all(t.is_contiguous() for t in (p, m, v, g)):
        raise ValueError("fused_adamw: p, m, v, g must be contiguous")
    if scalars.dtype != torch.float32 or scalars.shape != (4,):
        raise ValueError("fused_adamw: scalars must be float32 [clip, lr, 1/bc1, 1/bc2]")


def fused_adamw_leaf(p, m, v, g, scalars, b1: float = 0.9, b2: float = 0.999,
                     eps: float = 1e-8, wd: float = 0.01) -> None:
    """K3: update p, m, v of one leaf in place from grads g and the device
    scalars ``[clip, lr, 1/bc1, 1/bc2]`` (float32 [4])."""
    if p.device.type == "cpu":
        with torch.no_grad():
            for dst, src in zip((p, m, v), fused_adamw_leaf_ref(p, m, v, g, scalars,
                                                               b1, b2, eps, wd)):
                dst.copy_(src)
        return
    _check(p, m, v, g, scalars)
    with torch.cuda.device(p.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _lib().genhancer_fused_adamw(
            _DTYPES[p.dtype], _DTYPES[g.dtype], p.data_ptr(), m.data_ptr(), v.data_ptr(),
            g.data_ptr(), scalars.data_ptr(), p.numel(), b1, 1.0 - b1, b2, 1.0 - b2,
            eps, wd, stream)
    if rc != 0:
        raise RuntimeError(f"fused_adamw: CUDA kernel launch failed with cudaError {rc}")
    LAUNCHES["fused_adamw"] += 1


def adamw_scalars(gnorm: torch.Tensor, count: int, schedule: Callable[[int], float],
                  b1: float, b2: float, max_grad_norm: float) -> torch.Tensor:
    """The kernel's ``[clip, lr, 1/bc1, 1/bc2]`` on gnorm's device, without a
    host sync: ``clip = min(1, c / (||g|| + 1e-6))`` from the device norm (in
    the norm's dtype, then float32, as JAX); lr at the pre-increment count
    and the bias corrections at ``count`` in float32, filled in on the
    device.  ``count`` is the post-increment (1-based) step."""
    dt = gnorm.dtype
    clip = torch.clamp(as_dtype_scalar(max_grad_norm, dt)
                       / (gnorm + as_dtype_scalar(1e-6, dt)), max=1.0)
    cf = np.float32(count)
    one = np.float32(1.0)
    host = (np.float32(schedule(count - 1)),
            one / (one - np.float32(b1) ** cf), one / (one - np.float32(b2) ** cf))
    scalars = torch.empty(4, dtype=torch.float32, device=gnorm.device)
    scalars[0] = clip.to(torch.float32)
    for i, x in enumerate(host, start=1):
        scalars[i].fill_(float(x))
    return scalars


def fused_adamw_apply(params, mu, nu, grads, count: int, schedule,
                      b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                      weight_decay: float = 0.01, max_grad_norm: float = 1.0) -> torch.Tensor:
    """``fused_adamw_apply:338`` over flat ``{path: tensor}`` dicts: one
    global norm over every grad leaf, then K3 on each leaf, in place.
    ``count`` is the post-increment (1-based) step.  Returns the norm."""
    gnorm = global_norm(grads)
    scalars = adamw_scalars(gnorm, count, schedule, b1, b2, max_grad_norm)
    with torch.no_grad():
        for key in params:
            fused_adamw_leaf(params[key], mu[key], nu[key], grads[key], scalars,
                             b1, b2, eps, weight_decay)
    return gnorm
