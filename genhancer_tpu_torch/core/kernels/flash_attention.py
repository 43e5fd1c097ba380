"""Flash attention for long sequences: K5 (forward) and K5b (backward).

Port of ``genhancer_tpu/core/pallas/flash_attention.py``.  The kernels are
hand-written CUDA for Hopper in ``csrc/flash_attention.cu``: in bfloat16
warp-specialised kernels whose products are ``wgmma`` and whose tiles arrive
by TMA (building blocks in ``csrc/flash_sm90.cuh``); in float32 the
split-TF32 ``wgmma`` forward of ``csrc/attention_tf32.cuh`` (shared with K1
and K2, see ``short_attention.py``) and the scalar backward of
``csrc/attention_tiles.cuh``.  This module holds their wrappers,
their plain PyTorch versions, the ``torch.autograd.Function`` that joins the
two halves, and the launch counters.

``flash_attention(q, k, v)``: exact unmasked softmax attention, no RoPE (the
caller has rotated q and k).  q, k, v are ``[B, L, H, D]`` (any B/L/H
strides, D contiguous; D a multiple of 8 up to 128, so 64, 72 and 128), any
L; the result is a new contiguous ``[B, L, H, D]``.  The forward also writes
each row's log-sum-exp ``[B, H, L]`` float32 (``_fwd_kernel:70-71``), which
the backward reads back to recompute ``p = exp(s - lse)``; the backward
returns new contiguous dq, dk, dv.

Rounding points, which differ from K1b/K2b (``short_attention.py``) in dv:
  * forward: ``p = e * (1 / den)`` normalised before it is rounded to v's
    dtype for the float32-accumulated PV product (``_fwd_kernel:63-68``),
    as K1/K2 do;
  * backward: ``p = exp(s - lse)``; ``dp = dO_bf16 V^T``, ``ds = p (dp -
    D_i)``; dq = bf16(ds) K * scale and dk = bf16(ds)^T Q * scale, the scale
    after the product; **dv = p^T dO with p unrounded float32 and dO in
    float32** (``_dkv_kernel:203-205``), where K1b/K2b round p first.

The TPU's VMEM ceiling (``flash_supported``) and the query-chunked fallback
past it (``core.attention.sdpa_xla_qchunk``) have no counterpart: the CUDA
kernel streams K/V and takes any L.

The bfloat16 kernels (``csrc/attention_sm90.cuh``, shared with K1, K2 and
K1b) read q, k, v (and the backward's dO) through TMA tensor maps, which
need each base pointer and each B/L/H stride in bytes to be a multiple of
16, and D contiguous (``short_attention._tma_layout_error``; strides of
size-1 dimensions are never followed and do not count).  The DiT's layouts pass
without a copy: ``apply_rope``'s fresh q and k, the ``_split_qkv`` views of a
fused projection, the ``torch.cat`` results of the double blocks.  A layout
that fails raises ``ValueError``; nothing is copied to make it pass.  The
head dim is padded to 64 or 128 in shared memory, so every D the wrapper
takes (a multiple of 8 up to 128) has its kernel.

A CUDA tensor launches the kernel or raises; a CPU tensor takes the plain
version (``*_ref``), which the tests and ``chip_smoke.py`` also compare the
kernel against.  ``LAUNCHES`` counts kernel-wrapper launches only.
"""

from __future__ import annotations

import ctypes
from typing import Dict

import torch

from . import _build
from .short_attention import (_DTYPES, _check, _check_tma_layout, _raise_on, _tma_strides,
                              _under_grad)

LAUNCHES: Dict[str, int] = {"flash_attention": 0, "flash_attention_bwd": 0}

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_I = ctypes.c_int


# ---------------------------------------------------------------- plain versions

def flash_attention_fwd_ref(q, k, v):
    """Plain version of K5 (``_fwd_kernel:55``) on [B, L, H, D]: returns
    (o in q's dtype, lse [B, H, L] float32)."""
    f32 = torch.float32
    scale = 1.0 / (q.shape[-1] ** 0.5)
    s = torch.einsum("blhd,bmhd->bhlm", q.to(f32), k.to(f32)) * scale
    mx = s.amax(dim=-1, keepdim=True)
    e = torch.exp(s - mx)
    den = e.sum(dim=-1, keepdim=True)
    p = e * (1.0 / den)
    o = torch.einsum("bhlm,bmhd->blhd", p.to(v.dtype).to(f32), v.to(f32))
    return o.to(q.dtype), (mx + torch.log(den))[..., 0]


def flash_attention_bwd_ref(q, k, v, o, lse, do):
    """Plain version of K5b (``_dq_kernel:156`` and ``_dkv_kernel:175``) on
    [B, L, H, D], from the forward's lse [B, H, L]: returns new contiguous
    (dq, dk, dv) in the input dtype."""
    f32 = torch.float32
    scale = 1.0 / (q.shape[-1] ** 0.5)
    dof = do.to(f32)
    s = torch.einsum("blhd,bmhd->bhlm", q.to(f32), k.to(f32)) * scale
    p = torch.exp(s - lse[..., None])
    dp = torch.einsum("blhd,bmhd->bhlm", dof.to(v.dtype).to(f32), v.to(f32))
    d_i = (dof * o.to(f32)).sum(dim=-1).permute(0, 2, 1)[..., None]   # [B, H, L, 1]
    ds = p * (dp - d_i)
    dq = torch.einsum("bhlm,bmhd->blhd", ds.to(k.dtype).to(f32), k.to(f32)) * scale
    dk = torch.einsum("bhlm,blhd->bmhd", ds.to(q.dtype).to(f32), q.to(f32)) * scale
    dv = torch.einsum("bhlm,blhd->bmhd", p, dof)
    return (dq.to(q.dtype).contiguous(), dk.to(k.dtype).contiguous(),
            dv.to(v.dtype).contiguous())


# ---------------------------------------------------------------- kernel wrappers

def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_attention")
    if not getattr(lib, "_genhancer_typed", False):
        strides = [_I64] * 9
        tail = [_I] * 4 + [ctypes.c_float, _P]
        lib.genhancer_flash_attention_fwd.argtypes = [_I] + [_P] * 5 + strides + tail
        lib.genhancer_flash_attention_bwd.argtypes = [_I] + [_P] * 10 + strides + tail
        lib.genhancer_flash_attention_fwd.restype = _I
        lib.genhancer_flash_attention_bwd.restype = _I
        lib._genhancer_typed = True
    return lib


def _fwd_kernel(q, k, v, want_lse: bool):
    """Launch K5; returns (o, lse or None)."""
    _check("flash_attention", q, k, v)
    _check_tma_layout("flash_attention", q, k, v)
    b, l, h, d = q.shape
    o = torch.empty((b, l, h, d), dtype=q.dtype, device=q.device)
    lse = (torch.empty((b, h, l), dtype=torch.float32, device=q.device)
           if want_lse else None)
    with torch.cuda.device(q.device):
        rc = _lib().genhancer_flash_attention_fwd(
            _DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr() if want_lse else None, *_tma_strides(q, k, v), b, l, h, d,
            1.0 / (d ** 0.5), torch.cuda.current_stream().cuda_stream)
    _raise_on(rc, "flash_attention")
    LAUNCHES["flash_attention"] += 1
    return o, lse


def _bwd_kernel(q, k, v, o, lse, do):
    """Launch K5b; returns (dq, dk, dv)."""
    name = "flash_attention_bwd"
    _check(name, q, k, v)
    b, l, h, d = q.shape
    if do.shape != q.shape or do.device != q.device:
        raise ValueError(f"{name}: the output gradient must be [B, L, H, D] on q's device")
    if lse.shape != (b, h, l) or lse.dtype != torch.float32 or not lse.is_contiguous():
        raise ValueError(f"{name}: lse must be a contiguous float32 [B, H, L]")
    do = do.to(q.dtype).contiguous()
    o = o.contiguous()
    _check_tma_layout(name, q, k, v, do)
    di = torch.empty((b, h, l), dtype=torch.float32, device=q.device)
    dq, dk, dv = (torch.empty((b, l, h, d), dtype=q.dtype, device=q.device)
                  for _ in range(3))
    with torch.cuda.device(q.device):
        rc = _lib().genhancer_flash_attention_bwd(
            _DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            do.data_ptr(), lse.data_ptr(), di.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), *_tma_strides(q, k, v), b, l, h, d, 1.0 / (d ** 0.5),
            torch.cuda.current_stream().cuda_stream)
    _raise_on(rc, name)
    LAUNCHES[name] += 1
    return dq, dk, dv


# ---------------------------------------------------------------- autograd

class _FlashAttention(torch.autograd.Function):
    """K5 forward + K5b backward; on CPU tensors the plain versions."""

    @staticmethod
    def forward(ctx, q, k, v):
        if q.device.type == "cpu":
            o, lse = flash_attention_fwd_ref(q, k, v)
        else:
            o, lse = _fwd_kernel(q, k, v, want_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        if q.device.type == "cpu":
            return flash_attention_bwd_ref(q, k, v, o, lse, do)
        return _bwd_kernel(q, k, v, o, lse, do)


def flash_attention(q, k, v):
    """K5: exact softmax attention without RoPE, any L. [B, L, H, D].
    Differentiable in q, k, v (K5b)."""
    if _under_grad(q, k, v):
        return _FlashAttention.apply(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_fwd_ref(q, k, v)[0]
    return _fwd_kernel(q, k, v, want_lse=False)[0]
