"""Fused clip + AdamW update: K3, its int8 weight emission K4, and the
8-bit-moment update K6.

Port of ``genhancer_tpu/core/pallas/adamw.py``.  The kernels are
hand-written CUDA for Hopper in ``csrc/adamw.cu``; this module holds their
wrappers, their plain PyTorch versions and their launch counters, plus the
tree-level ``fused_adamw_apply``.

* ``fused_adamw_leaf(p, m, v, g, scalars, ...)`` — K3 on one leaf, in
  place; any shape (the TPU's (8, 128) tile rule does not apply to a flat
  elementwise kernel);
* ``fused_adamw_leaf_ref`` — ``_update_leaf_xla:328`` (returns new tensors);
* ``fused_adamw_quant_leaf(p, m, v, g, scalars, wq, ws, ...)`` — K4: K3 on
  a [rows, cols] leaf plus ``quantize_weight`` of the stored new p written
  into ``wq`` int8 [rows, cols] and ``ws`` float32 [rows], in place
  (``_adamw_quant_kernel:163``);
* ``fused_adamw8_leaf(p, m8, v8, g, scalars, ..., wq=None, ws=None)`` — K6
  on ``Moment8`` moments, with K4's emission when ``wq``/``ws`` are given
  (``_adamw8_kernel:120``, ``_adamw8_quant_kernel:130``);
* ``fused_adamw_apply(params, mu, nu, grads, count, schedule, ...,
  quant=None, rows=None)`` — ``fused_adamw_apply:338`` over flat ``{path:
  tensor}`` dicts, in place; ``quant`` maps the paths whose int8 copy the
  update emits to their (wq, ws) buffers, ``rows`` the paths updated by
  row range under ZeRO-1 to their ``(r0, r1)``.

The port updates p, m, v and the weight cache in place, where the JAX
package returns new arrays: the kernels' only traffic is the one read and
one write of each.

A CUDA tensor launches the kernel or raises; a CPU tensor takes the plain
version.  ``LAUNCHES`` counts kernel launches only, K6's two bodies apart.
"""

from __future__ import annotations

import ctypes
from typing import Callable, Dict, NamedTuple, Optional

import numpy as np
import torch

from ...parallel import mesh
from ..nn import as_dtype_scalar
from . import _build
from .rowquant import div127

LAUNCHES: Dict[str, int] = {"fused_adamw": 0, "fused_adamw_quant": 0, "fused_adamw8": 0,
                            "fused_adamw8_quant": 0}

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def global_norm(grads: Dict[str, torch.Tensor],
                axes: Optional[Dict[str, str]] = None) -> torch.Tensor:
    """``optax.global_norm`` on a flat dict: leaves in sorted key order (the
    order ``jax.tree.leaves`` walks a dict), each leaf's sum of squares
    accumulated in float32 and rounded to the leaf's dtype, the per-leaf
    sums added with type promotion, then the square root.

    ``axes`` names the leaves that are the rank's block of a sharded leaf
    and the mesh axis ("model", "data" or "world") their blocks span: their
    float32 sums are added over that axis first (one collective per axis),
    so each leaf counts whole and once; a replicated leaf counts once."""
    axes = axes or {}
    sums = {key: (x * x).sum(dtype=torch.float32) for key, x in grads.items()}
    for axis in (mesh.MODEL_AXIS, mesh.DATA_AXIS, "world"):
        keys = [k for k in sorted(grads) if axes.get(k) == axis]
        if keys and mesh.axis_size(axis) > 1:
            spread = mesh.all_reduce_(torch.stack([sums[k] for k in keys]), axis)
            sums.update(zip(keys, spread))
    total = 0
    for key in sorted(grads):
        total = total + sums[key].to(grads[key].dtype)
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
        lib.genhancer_fused_adamw_quant.argtypes = (
            [ctypes.c_int] * 2 + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 2
            + [ctypes.c_float] * 6 + [ctypes.c_void_p] * 3)
        lib.genhancer_fused_adamw_quant.restype = ctypes.c_int
        lib.genhancer_fused_adamw8.argtypes = (
            [ctypes.c_int] * 2 + [ctypes.c_void_p] * 7 + [ctypes.c_int] * 2
            + [ctypes.c_float] * 6 + [ctypes.c_void_p] * 3)
        lib.genhancer_fused_adamw8.restype = ctypes.c_int
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


def _quantize_rows(pf: torch.Tensor):
    """``quantize_weight`` along rows of a float32 [rows, cols] matrix:
    (int8, float32 [rows])."""
    ws = div127(torch.clamp_min(pf.abs().amax(dim=1, keepdim=True), 1e-12))
    return torch.clamp(torch.round(pf / ws), -127, 127).to(torch.int8), ws[:, 0]


def fused_adamw_quant_leaf_ref(p, m, v, g, scalars, b1, b2, eps, wd):
    """Plain version of K4, ``_adamw_quant_kernel:163``: K3's update, then
    the int8 copy of the stored new p.  Returns (p, m, v, wq, ws [rows])."""
    p2, m2, v2 = fused_adamw_leaf_ref(p, m, v, g, scalars, b1, b2, eps, wd)
    return (p2, m2, v2) + _quantize_rows(p2.to(torch.float32))


def _check_quant(p, wq, ws) -> None:
    if p.dim() != 2 or wq.shape != p.shape or wq.dtype != torch.int8 or not wq.is_contiguous():
        raise ValueError(f"fused_adamw: wq must be contiguous int8 {tuple(p.shape)} for a 2-D p")
    if ws.shape != (p.shape[0],) or ws.dtype != torch.float32 or not ws.is_contiguous():
        raise ValueError(f"fused_adamw: ws must be contiguous float32 [{p.shape[0]}]")
    if wq.device != p.device or ws.device != p.device:
        raise ValueError("fused_adamw: wq and ws must be on p's device")


def fused_adamw_quant_leaf(p, m, v, g, scalars, wq, ws, b1: float = 0.9, b2: float = 0.999,
                           eps: float = 1e-8, wd: float = 0.01) -> None:
    """K4: K3 on a [rows, cols] leaf, in place, and ``quantize_weight`` of
    the stored new p into ``wq`` (int8 [rows, cols]) and ``ws`` (float32
    [rows]), in place."""
    if p.device.type == "cpu":
        with torch.no_grad():
            out = fused_adamw_quant_leaf_ref(p, m, v, g, scalars, b1, b2, eps, wd)
            for dst, src in zip((p, m, v, wq, ws), out):
                dst.copy_(src)
        return
    _check(p, m, v, g, scalars)
    _check_quant(p, wq, ws)
    rows, cols = p.shape
    with torch.cuda.device(p.device):
        rc = _lib().genhancer_fused_adamw_quant(
            _DTYPES[p.dtype], _DTYPES[g.dtype], p.data_ptr(), m.data_ptr(), v.data_ptr(),
            g.data_ptr(), scalars.data_ptr(), rows, cols, b1, 1.0 - b1, b2, 1.0 - b2, eps, wd,
            wq.data_ptr(), ws.data_ptr(), torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"fused_adamw_quant: CUDA kernel launch failed with cudaError {rc}")
    LAUNCHES["fused_adamw_quant"] += 1


# ---------------------------------------------------------------------------
# 8-bit moments: log-coded int8 with one float32 scale per row
# (``adamw.py:45-105``): q = round(K log2(x / s)) at K = 4 covers s 2^-31.75
# to s with at most 9.05% relative error; v's exact zero is code -127, m's 0.
# ---------------------------------------------------------------------------

MOMENT8_K = 4.0
_M8_TINY = 1e-38


class Moment8(NamedTuple):
    """An 8-bit moment leaf: codes int8 [rows, cols], scales float32 [rows, 1]."""
    q: torch.Tensor
    s: torch.Tensor


def moment8_ok(p) -> bool:
    """``moment8_ok:277``: the leaves that keep 8-bit moments (2-D, columns a
    multiple of 128, rows of 32, at least 64 k elements); the others keep
    dense moments."""
    return (p.dim() == 2 and p.shape[1] % 128 == 0 and p.shape[0] % 32 == 0
            and p.numel() >= 64 * 1024)


def moment8_zeros_m(p) -> Moment8:
    return Moment8(torch.zeros(p.shape, dtype=torch.int8, device=p.device),
                   torch.zeros((p.shape[0], 1), dtype=torch.float32, device=p.device))


def moment8_zeros_v(p) -> Moment8:
    return Moment8(torch.full(p.shape, -127, dtype=torch.int8, device=p.device),
                   torch.zeros((p.shape[0], 1), dtype=torch.float32, device=p.device))


def _one_over(s: torch.Tensor) -> torch.Tensor:
    """``1.0 / s`` as an IEEE division (see ``div127``)."""
    return torch.tensor(1.0, dtype=torch.float32, device=s.device) / s


def _m8_code(a: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """round(K log2(max(a, tiny) * (1 / max(s, tiny)))): a reciprocal and a
    product, as JAX, not a division."""
    ratio = torch.clamp_min(a, _M8_TINY) * _one_over(torch.clamp_min(s, _M8_TINY))
    return torch.round(MOMENT8_K * torch.log2(ratio))


def m8_encode_v(v: torch.Tensor) -> Moment8:
    s = v.amax(dim=1, keepdim=True)
    q = torch.clamp(_m8_code(v, s), -126.0, 0.0)
    return Moment8(torch.where(v > 0.0, q, -127.0).to(torch.int8), s.to(torch.float32))


def m8_decode_v(q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    qf = q.to(torch.float32)
    return torch.where(qf <= -127.0, 0.0, s * torch.exp2(qf * (1.0 / MOMENT8_K)))


def m8_encode_m(m: torch.Tensor) -> Moment8:
    a = m.abs()
    s = a.amax(dim=1, keepdim=True)
    mag = torch.clamp(_m8_code(a, s) + 127.0, 1.0, 127.0)
    return Moment8(torch.where(m == 0.0, 0.0, torch.sign(m) * mag).to(torch.int8),
                   s.to(torch.float32))


def m8_decode_m(q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    qf = q.to(torch.float32)
    mag = s * torch.exp2((qf.abs() - 127.0) * (1.0 / MOMENT8_K))
    return torch.where(qf == 0.0, 0.0, torch.sign(qf) * mag)


def fused_adamw8_leaf_ref(p, m8: Moment8, v8: Moment8, g, scalars, b1, b2, eps, wd,
                          quant: bool = False):
    """Plain version of K6, ``_adamw8_math:108``: decode, K3's update in
    float32, encode.  Returns (p, Moment8 m, Moment8 v) and, with ``quant``,
    the int8 copy of the stored p and its scales [rows] (``_adamw8_quant_
    kernel:130``)."""
    f32 = torch.float32
    scale, lr, inv_bc1, inv_bc2 = (scalars[0], scalars[1], scalars[2], scalars[3])
    gf = g.to(f32) * scale
    m = b1 * m8_decode_m(m8.q, m8.s) + (1.0 - b1) * gf
    v = b2 * m8_decode_v(v8.q, v8.s) + (1.0 - b2) * gf * gf
    pf = p.to(f32)
    pf = pf - lr * ((m * inv_bc1) / (torch.sqrt(v * inv_bc2) + eps) + wd * pf)
    out = (pf.to(p.dtype), m8_encode_m(m), m8_encode_v(v))
    return out + _quantize_rows(out[0].to(f32)) if quant else out


def fused_adamw8_leaf(p, m8: Moment8, v8: Moment8, g, scalars, b1: float = 0.9,
                      b2: float = 0.999, eps: float = 1e-8, wd: float = 0.01,
                      wq: Optional[torch.Tensor] = None,
                      ws: Optional[torch.Tensor] = None) -> None:
    """K6: the AdamW update of a [rows, cols] leaf on 8-bit moments, p and
    the moments' codes and scales in place; with ``wq``/``ws`` also K4's
    int8 copy of the stored new p, in place."""
    quant = wq is not None
    if quant != (ws is not None):
        raise ValueError("fused_adamw8: give both wq and ws, or neither")
    if p.device.type == "cpu":
        with torch.no_grad():
            out = fused_adamw8_leaf_ref(p, m8, v8, g, scalars, b1, b2, eps, wd, quant)
            p.copy_(out[0])
            for dst, src in zip((m8.q, m8.s, v8.q, v8.s), (*out[1], *out[2])):
                dst.copy_(src)
            if quant:
                wq.copy_(out[3])
                ws.copy_(out[4])
        return
    if not (p.is_cuda and p.dim() == 2 and p.dtype in _DTYPES and g.dtype in _DTYPES
            and g.shape == p.shape and p.is_contiguous() and g.is_contiguous()
            and all(t.device == p.device for t in (g, scalars, *m8, *v8))):
        raise ValueError("fused_adamw8: p and g must be contiguous 2-D float32/bfloat16 on "
                         "one CUDA device with the moments and scalars")
    rows = p.shape[0]
    for mom in (m8, v8):
        if (mom.q.shape != p.shape or mom.q.dtype != torch.int8 or mom.s.shape != (rows, 1)
                or mom.s.dtype != torch.float32
                or not (mom.q.is_contiguous() and mom.s.is_contiguous())):
            raise ValueError("fused_adamw8: a Moment8 is contiguous int8 codes of p's shape "
                             "and float32 scales [rows, 1]")
    if scalars.dtype != torch.float32 or scalars.shape != (4,):
        raise ValueError("fused_adamw8: scalars must be float32 [clip, lr, 1/bc1, 1/bc2]")
    if quant:
        _check_quant(p, wq, ws)
    with torch.cuda.device(p.device):
        rc = _lib().genhancer_fused_adamw8(
            _DTYPES[p.dtype], _DTYPES[g.dtype], p.data_ptr(), m8.q.data_ptr(), m8.s.data_ptr(),
            v8.q.data_ptr(), v8.s.data_ptr(), g.data_ptr(), scalars.data_ptr(), rows,
            p.shape[1], b1, 1.0 - b1, b2, 1.0 - b2, eps, wd,
            wq.data_ptr() if quant else None, ws.data_ptr() if quant else None,
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"fused_adamw8: CUDA kernel launch failed with cudaError {rc}")
    LAUNCHES["fused_adamw8_quant" if quant else "fused_adamw8"] += 1


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
                      weight_decay: float = 0.01, max_grad_norm: float = 1.0,
                      quant: Optional[dict] = None,
                      rows: Optional[Dict[str, tuple]] = None,
                      layout: Optional[dict] = None) -> torch.Tensor:
    """``fused_adamw_apply:338`` over flat ``{path: tensor}`` dicts: one
    global norm over every grad leaf, then one kernel per leaf, in place —
    K6 where the moments are ``Moment8``, K3 elsewhere, each with K4's
    emission of the int8 copy for the paths in ``quant`` (``{path: (wq,
    ws)}``, written in place).  ``count`` is the post-increment (1-based)
    step.  Returns the norm.

    ZeRO-1: ``rows`` (``{path: (r0, r1)}``) names the leaves whose moments
    cover rows ``[r0, r1)`` only; those leaves update the views
    ``p[r0:r1]`` from ``g[r0:r1]`` and write ``wq[r0:r1]``, ``ws[r0:r1]``,
    in place and without a copy (every kernel is per row or per element
    and takes any row count).  A view whose base is not 16-byte aligned
    takes the kernel's own unaligned path.  The norm is over the whole
    gradients.

    Tensor parallel: ``layout`` (``parallel.layout``) places the leaves that
    are the rank's block; the norm counts each whole and once, and each
    kernel runs on the rank's block, elementwise and per row as it is.  A
    row of a row-parallel leaf spans the model axis, and K4's int8 scale
    and K6's moment scales are per row: one launch cannot wait for the
    other ranks' amax, so those leaves (K4 or K6 with a model-sharded
    input dim) are updated on their gathered rows, every model rank alike,
    and each keeps its columns, the whole rows' scales."""
    layout = layout or {}
    gnorm = global_norm(grads, {k: pl.axes for k, pl in layout.items() if k in grads})
    scalars = adamw_scalars(gnorm, count, schedule, b1, b2, max_grad_norm)
    quant = quant or {}
    rows = rows or {}
    hyper = dict(b1=b1, b2=b2, eps=eps, wd=weight_decay)

    def view(x, key):
        return x[rows[key][0]:rows[key][1]] if key in rows else x

    with torch.no_grad():
        for key in params:
            pl = layout.get(key)
            if pl is not None and pl.dim(mesh.MODEL_AXIS) == 1 and (
                    key in quant or isinstance(mu[key], Moment8)):
                _whole_rows_update(params[key], mu[key], nu[key], grads[key], scalars, pl,
                                   quant.get(key), hyper)
                continue
            args = (view(params[key], key), mu[key], nu[key], view(grads[key], key), scalars)
            wq, ws = quant.get(key, (None, None))
            if wq is not None:
                wq, ws = view(wq, key), view(ws, key)
            if isinstance(mu[key], Moment8):
                fused_adamw8_leaf(*args, wq=wq, ws=ws, **hyper)
            elif key in quant:
                fused_adamw_quant_leaf(*args, wq, ws, **hyper)
            else:
                fused_adamw_leaf(*args, **hyper)
    return gnorm


def _whole_rows_update(p, m, v, g, scalars, pl, cache, hyper) -> None:
    """K4 or K6 on the gathered rows of a row-parallel leaf (``pl``: its
    placement): p, g, the dense moments or the 8-bit codes and the int8
    copy gathered over the model axis, the kernel run on the whole leaf
    (K6's and K4's row scales are whole, and shared), each block written
    back in place."""
    from ...parallel.layout import gather, shard
    whole = [gather(t, pl) for t in (p, g)]
    if isinstance(m, Moment8):
        mw, vw = Moment8(gather(m.q, pl), m.s), Moment8(gather(v.q, pl), v.s)
    else:
        mw, vw = gather(m, pl), gather(v, pl)
    wq = ws = None
    if cache is not None:
        wq, ws = gather(cache[0], pl), cache[1]
    if isinstance(m, Moment8):
        fused_adamw8_leaf(whole[0], mw, vw, whole[1], scalars, wq=wq, ws=ws, **hyper)
        pairs = [(m.q, mw.q), (v.q, vw.q)]
    else:
        fused_adamw_quant_leaf(whole[0], mw, vw, whole[1], scalars, wq, ws, **hyper)
        pairs = [(m, mw), (v, vw)]
    pairs += [(p, whole[0])] + ([(cache[0], wq)] if cache is not None else [])
    for block, full in pairs:
        block.copy_(shard(full, pl))
