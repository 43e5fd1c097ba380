"""Fused short-sequence attention: K1/K1b (RoPE + attention) and K2/K2b
(attention), forward and backward.

Port of ``genhancer_tpu/core/pallas/short_attention.py``.  The kernels are
hand-written CUDA for Hopper in ``csrc/short_attention.cu`` (in bf16 the
wgmma/TMA kernels of ``csrc/attention_sm90.cuh``); this module holds their
wrappers, their plain PyTorch versions, the ``torch.autograd.Function``s
that join the two halves, the launch counters, and the TMA layout rule the
bf16 kernels here and in ``flash_attention.py`` share.

* ``fused_rope_attention(q, k, v, cos, sin)`` — K1 forward, K1b backward;
  every DiT block;
* ``fused_attention(q, k, v)`` — K2 forward, K2b backward; every tower
  encoder layer.

q, k, v are ``[B, L, H, D]`` (D contiguous; in bf16 the layout rule below),
cos/sin ``[B, L, D/2]``; the result is a new contiguous ``[B, L, H, D]``.
K1's launch first writes the rotated pair ``rq, rk`` (contiguous, rounded to
the input dtype: the TPU kernel's rounding point), then runs K2's attention
on ``(rq, rk, v)``.  Under autograd the forward keeps ``rq, rk`` in place of
q and k, and each row's log-sum-exp ``[B, H, L]``, for the backward, which
returns new contiguous dq, dk, dv (K1b un-rotates dq and dk) and no
gradient for cos/sin (as ``_vjp_bwd:271``).

The bf16 K1, K2, K1b and K2b read their operands through TMA tensor maps:
D contiguous, each base pointer and each B/L/H stride in bytes a multiple
of 16 (``_tma_layout_error``; strides of size-1 dimensions are never
followed and do not count).  A CUDA tensor that fails raises
``ValueError`` before any launch; nothing is copied to make it pass.  The
float32 kernels take any B/L/H strides.

In float32 the forward (K1, K2, and K5 in ``flash_attention.py``) runs on
the tensor cores as split TF32 (``csrc/attention_tf32.cuh``): each operand
x = hi + lo with hi = tf32(x), lo = tf32(x - hi), and each product as
hi hi + hi lo + lo hi, which keeps float32's accuracy.  Its plain version
stays ``sdpa_ref`` in exact float32; ``split_tf32_attention_ref`` emulates
the split (and, with terms left out, the controls that must miss the
card's mean-error bound of 1e-5), for the tests and ``chip_smoke.py``
only.  The float32 backward is the scalar kernels of
``csrc/attention_tiles.cuh``.

A CUDA tensor launches the kernel or raises; a CPU tensor takes the plain
version (``*_ref``), which the tests and ``chip_smoke.py`` also compare the
kernel against.  ``LAUNCHES`` counts kernel-wrapper launches only.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict

import torch

from ..attention import sdpa_ref
from ..rope import apply_rope
from . import _build

LAUNCHES: Dict[str, int] = {"fused_rope_attention": 0, "fused_attention": 0,
                            "fused_rope_attention_bwd": 0, "fused_attention_bwd": 0}

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_I = ctypes.c_int


# ---------------------------------------------------------------- plain versions

def fused_rope_attention_ref(q, k, v, cos, sin):
    """Plain version of K1: apply_rope in f32, cast back, then sdpa_ref."""
    return sdpa_ref(apply_rope(q, cos, sin), apply_rope(k, cos, sin), v)


def fused_attention_ref(q, k, v):
    """Plain version of K2."""
    return sdpa_ref(q, k, v)


# the three products of a split-TF32 product: (left part, right part), h = hi, l = lo
SPLIT_TERMS = ("hh", "hl", "lh")


def tf32_round(x):
    """float32 ``x`` rounded to TF32 (10 stored mantissa bits), to nearest
    with ties away from zero, as ``cvt.rna.tf32.f32``: half of the 13 low
    bits' weight added to the magnitude, then those bits cleared (a carry
    runs into the exponent; subnormals and zeros follow the same rule).
    Infinities and NaNs pass unchanged."""
    x = x.to(torch.float32).contiguous()
    bits = (x.view(torch.int32) + 0x1000) & -0x2000
    return torch.where(torch.isfinite(x), bits.view(torch.float32), x)


def _split_tf32(x):
    hi = tf32_round(x)
    return {"h": hi, "l": tf32_round(x - hi)}


def split_tf32_attention_ref(q, k, v, qk=SPLIT_TERMS, pv=SPLIT_TERMS):
    """Plain emulation of the float32 forward's split-TF32 products on
    [B, L, H, D]: S = sum of the ``qk`` terms of q and k's hi/lo parts,
    e = exp(S * scale - max), O = sum of the ``pv`` terms of e's and v's
    parts divided by the row sum; each term a float32 product of TF32
    values.  The default terms are the kernel's; leaving one out gives a
    control.  Run it with TF32 off (``torch.backends.cuda.matmul.
    allow_tf32 = False``) on the card.  Returns float32."""
    f32 = torch.float32
    scale = 1.0 / (q.shape[-1] ** 0.5)
    qs, ks, vs = (_split_tf32(x.to(f32)) for x in (q, k, v))
    s = sum(torch.einsum("blhd,bmhd->bhlm", qs[a], ks[b]) for a, b in qk) * scale
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    es = _split_tf32(e)
    o = sum(torch.einsum("bhlm,bmhd->blhd", es[a], vs[b]) for a, b in pv)
    return o / e.sum(dim=-1).permute(0, 2, 1)[..., None]


def _bwd_body_ref(rq, rk, v, o, do):
    """``_bwd_body:90`` line for line, on [B, L, H, D]: returns float32
    (d_rq, d_rk, dv), d_rq and d_rk already scaled."""
    f32 = torch.float32
    scale = 1.0 / (rq.shape[-1] ** 0.5)
    of, dof = o.to(f32), do.to(f32)
    s = torch.einsum("blhd,bmhd->bhlm", rq.to(f32), rk.to(f32)) * scale
    p = torch.softmax(s, dim=-1)
    dob = do.to(v.dtype)
    dp = torch.einsum("blhd,bmhd->bhlm", dob.to(f32), v.to(f32))
    d_i = (dof * of).sum(dim=-1).permute(0, 2, 1)[..., None]      # [B, H, L, 1]
    ds = (p * (dp - d_i)).to(rq.dtype).to(f32)
    d_rq = torch.einsum("bhlm,bmhd->blhd", ds, rk.to(f32)) * scale
    d_rk = torch.einsum("bhlm,blhd->bmhd", ds, rq.to(f32)) * scale
    dv = torch.einsum("bhlm,blhd->bmhd", p.to(dob.dtype).to(f32), dob.to(f32))
    return d_rq, d_rk, dv


def _rotated_bwd_ref(rq, rk, v, o, do, cos, sin):
    """K1b's plain body on the rotated pair: ``_bwd_body``, then d_rq/d_rk
    rounded, un-rotated with (cos, -sin) in f32 and rounded again."""
    d_rq, d_rk, dv = _bwd_body_ref(rq, rk, v, o, do)
    return (apply_rope(d_rq.to(rq.dtype), cos, -sin),
            apply_rope(d_rk.to(rk.dtype), cos, -sin), dv.to(v.dtype))


def fused_rope_attention_bwd_ref(q, k, v, o, do, cos, sin):
    """Plain version of K1b (``_bwd_kernel:112``): rotate q, k in f32 and
    round; the shared body; round d_rq/d_rk, un-rotate them with (cos, -sin)
    in f32 and round again.  Returns (dq, dk, dv) in the input dtype."""
    return _rotated_bwd_ref(apply_rope(q, cos, sin), apply_rope(k, cos, sin), v, o, do,
                            cos, sin)


def fused_attention_bwd_ref(q, k, v, o, do):
    """Plain version of K2b (``_bwd_kernel_norope:125``)."""
    d_rq, d_rk, dv = _bwd_body_ref(q, k, v, o, do)
    return d_rq.to(q.dtype), d_rk.to(k.dtype), dv.to(v.dtype)


# ---------------------------------------------------------------- kernel wrappers

def _lib() -> ctypes.CDLL:
    lib = _build.load("short_attention")
    if not getattr(lib, "_genhancer_typed", False):
        strides = [_I64] * 9
        tail = [_I] * 4 + [ctypes.c_float]
        lib.genhancer_fused_rope_attention_fwd.argtypes = ([_I] + [_P] * 9 + strides + tail
                                                          + [_I, _P])
        lib.genhancer_fused_attention_fwd.argtypes = [_I] + [_P] * 5 + strides + tail + [_I, _P]
        lib.genhancer_fused_rope_attention_bwd.argtypes = [_I] + [_P] * 12 + strides + tail + [_P]
        lib.genhancer_fused_attention_bwd.argtypes = [_I] + [_P] * 10 + strides + tail + [_P]
        for fn in ("genhancer_fused_rope_attention_fwd", "genhancer_fused_attention_fwd",
                   "genhancer_fused_rope_attention_bwd", "genhancer_fused_attention_bwd"):
            getattr(lib, fn).restype = _I
        lib._genhancer_typed = True
    return lib


def _check(name: str, q, k, v) -> None:
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError(f"{name}: q, k, v must be on one CUDA device, got "
                         f"{q.device}, {k.device}, {v.device}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{name}: q, k, v must share dtype float32 or bfloat16, "
                        f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.ndim != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"{name}: q, k, v must be [B, L, H, D] of one shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, l, h, d = q.shape
    if d % 8 or d > 128 or min(b, l, h) < 1 or max(b, h) > 65535:
        raise ValueError(f"{name}: kernel takes D a multiple of 8 up to 128 and "
                         f"non-empty B, L, H; got {tuple(q.shape)}")
    if q.stride(-1) != 1 or k.stride(-1) != 1 or v.stride(-1) != 1:
        raise ValueError(f"{name}: D must be contiguous (stride 1)")


_TMAP_ERROR = 10000   # sm90::TMAP_ERROR: a tensor map that did not encode, + CUresult


def _tma_layout_error(*ts):
    """Why the TMA cannot read these [B, L, H, D] bf16 tensors in place, or
    None: D contiguous, the base pointer and each B/L/H stride (of a
    dimension longer than 1) a multiple of 16 bytes and below 2^40.  Reads
    only shapes, strides, dtypes and ``data_ptr() % 16`` (each once: it runs
    before every launch)."""
    for i, t in enumerate(ts):
        shape, strides, es = t.shape, t.stride(), t.element_size()
        if shape[3] > 1 and strides[3] != 1:
            return f"operand {i}: D must be contiguous (stride 1), got stride {strides[3]}"
        if t.data_ptr() % 16:
            return (f"operand {i}: the TMA needs a 16-byte-aligned base pointer, got "
                    f"{t.data_ptr() % 16} bytes past one")
        for dim in range(3):
            st = strides[dim] * es
            if shape[dim] > 1 and (st % 16 or not 0 < st < 2 ** 40):
                return (f"operand {i}: the TMA needs each B/L/H stride to be a positive "
                        f"multiple of 16 bytes, got {strides[dim]} elements "
                        f"({st} bytes) in dimension {dim}")
    return None


def _check_tma_layout(name: str, *ts) -> None:
    """Raise ``ValueError`` where the bf16 kernels' TMA cannot read ``ts``
    in place (the float32 kernels load their tiles with the threads and
    take any strides)."""
    err = _tma_layout_error(*ts) if ts[0].dtype == torch.bfloat16 else None
    if err is not None:
        raise ValueError(f"{name}: {err}")


def _tma_strides(*ts):
    """(B, L, H) element strides of each tensor, those of size-1 dimensions
    replaced by the contiguous stride (never followed; keeps the tensor map
    legal)."""
    out = []
    for t in ts:
        (b, l, h, d), st = t.shape, t.stride()
        out += [st[0] if b > 1 else l * h * d, st[1] if l > 1 else h * d, st[2] if h > 1 else d]
    return out


def _tables(q, cos, sin):
    b, l, h, d = q.shape
    if cos.shape != (b, l, d // 2) or sin.shape != (b, l, d // 2):
        raise ValueError(f"fused_rope_attention: cos/sin must be [{b}, {l}, {d // 2}], "
                         f"got {tuple(cos.shape)}, {tuple(sin.shape)}")
    if cos.device != q.device or sin.device != q.device:
        raise ValueError("fused_rope_attention: cos/sin must be on q's device")
    return cos.to(torch.float32).contiguous(), sin.to(torch.float32).contiguous()


def _raise_on(rc: int, name: str) -> None:
    if rc >= _TMAP_ERROR:
        raise RuntimeError(f"{name}: cuTensorMapEncodeTiled failed with CUresult "
                           f"{rc - _TMAP_ERROR}")
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA kernel launch failed with cudaError {rc}")


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def block_rows(b: int, l: int, h: int, sms: int) -> int:
    """q rows per block of the bf16 forward: 64 (one consumer warpgroup)
    where 128-row blocks would leave some of the card's ``sms`` SMs idle,
    else 128."""
    return 64 if b * h * -(-l // 128) < sms else 128


def _fwd_kernel(q, k, v, tables, want_lse: bool, rows=None):
    """Launch K1 (``tables`` = (cos, sin)) or K2 (``tables`` = None), with
    ``rows`` q rows per bf16 block (default ``block_rows``).  Returns
    (o, lse or None, rq, rk): the rotated pair K1 wrote (q and k themselves
    for K2), which the backward reads."""
    name = "fused_attention" if tables is None else "fused_rope_attention"
    _check(name, q, k, v)
    _check_tma_layout(name, q, k, v)
    b, l, h, d = q.shape
    rows = rows or block_rows(b, l, h, _sm_count(q.device.index))
    o = torch.empty((b, l, h, d), dtype=q.dtype, device=q.device)
    lse = (torch.empty((b, h, l), dtype=torch.float32, device=q.device)
           if want_lse else None)
    lse_ptr = lse.data_ptr() if want_lse else None
    tail = [b, l, h, d, 1.0 / (d ** 0.5), rows]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        head = [_DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr()]
        if tables is None:
            rq, rk = q, k
            rc = _lib().genhancer_fused_attention_fwd(
                *head, o.data_ptr(), lse_ptr, *_tma_strides(q, k, v), *tail, stream)
        else:
            cos, sin = _tables(q, *tables)
            rq, rk = torch.empty_like(o), torch.empty_like(o)
            rc = _lib().genhancer_fused_rope_attention_fwd(
                *head, cos.data_ptr(), sin.data_ptr(), rq.data_ptr(), rk.data_ptr(),
                o.data_ptr(), lse_ptr, *_tma_strides(q, k, v), *tail, stream)
    _raise_on(rc, name)
    LAUNCHES[name] += 1
    return o, lse, rq, rk


def _bwd_kernel(rq, rk, v, o, lse, do, tables):
    """Launch K1b (``tables`` = (cos, sin): ``rq, rk`` are the rotated pair
    K1 wrote, and dq, dk come out un-rotated) or K2b (``rq, rk`` = q, k);
    returns (dq, dk, dv)."""
    name = "fused_attention_bwd" if tables is None else "fused_rope_attention_bwd"
    _check(name, rq, rk, v)
    b, l, h, d = rq.shape
    if do.shape != rq.shape or do.device != rq.device:
        raise ValueError(f"{name}: the output gradient must be [B, L, H, D] on q's device")
    do = do.to(rq.dtype).contiguous()
    _check_tma_layout(name, rq, rk, v, do)
    di = torch.empty((b, h, l), dtype=torch.float32, device=rq.device)
    dq, dk, dv = (torch.empty((b, l, h, d), dtype=rq.dtype, device=rq.device)
                  for _ in range(3))
    with torch.cuda.device(rq.device):
        stream = torch.cuda.current_stream().cuda_stream
        head = [_DTYPES[rq.dtype], rq.data_ptr(), rk.data_ptr(), v.data_ptr(),
                o.data_ptr(), do.data_ptr()]
        tail = [lse.data_ptr(), di.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                dv.data_ptr(), *_tma_strides(rq, rk, v), b, l, h, d, 1.0 / (d ** 0.5), stream]
        if tables is None:
            rc = _lib().genhancer_fused_attention_bwd(*head, *tail)
        else:
            cos, sin = _tables(rq, *tables)
            rc = _lib().genhancer_fused_rope_attention_bwd(
                *head, cos.data_ptr(), sin.data_ptr(), *tail)
    _raise_on(rc, name)
    LAUNCHES[name] += 1
    return dq, dk, dv


# ---------------------------------------------------------------- autograd

class _FusedRopeAttention(torch.autograd.Function):
    """K1 forward + K1b backward; on CPU tensors the plain versions.  Both
    keep the rotated pair for the backward in place of q and k."""

    @staticmethod
    def forward(ctx, q, k, v, cos, sin):
        if q.device.type == "cpu":
            rq, rk = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
            o, lse = sdpa_ref(rq, rk, v), None
        else:
            o, lse, rq, rk = _fwd_kernel(q, k, v, (cos, sin), want_lse=True)
        ctx.save_for_backward(rq, rk, v, cos, sin, o, lse)
        return o

    @staticmethod
    def backward(ctx, do):
        rq, rk, v, cos, sin, o, lse = ctx.saved_tensors
        if rq.device.type == "cpu":
            grads = _rotated_bwd_ref(rq, rk, v, o, do, cos, sin)
        else:
            grads = _bwd_kernel(rq, rk, v, o, lse, do, (cos, sin))
        return (*grads, None, None)


class _FusedAttention(torch.autograd.Function):
    """K2 forward + K2b backward; on CPU tensors the plain versions."""

    @staticmethod
    def forward(ctx, q, k, v):
        if q.device.type == "cpu":
            o, lse = fused_attention_ref(q, k, v), None
        else:
            o, lse = _fwd_kernel(q, k, v, None, want_lse=True)[:2]
        ctx.save_for_backward(q, k, v, o, lse)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        if q.device.type == "cpu":
            return fused_attention_bwd_ref(q, k, v, o, do)
        return _bwd_kernel(q, k, v, o, lse, do, None)


def _under_grad(*ts) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def fused_rope_attention(q, k, v, cos, sin):
    """K1: RoPE on q, k then exact softmax attention. [B, L, H, D].
    Differentiable in q, k, v (K1b)."""
    if _under_grad(q, k, v):
        return _FusedRopeAttention.apply(q, k, v, cos, sin)
    if q.device.type == "cpu":
        return fused_rope_attention_ref(q, k, v, cos, sin)
    return _fwd_kernel(q, k, v, (cos, sin), want_lse=False)[0]


def fused_attention(q, k, v):
    """K2: exact softmax attention without RoPE. [B, L, H, D].
    Differentiable in q, k, v (K2b)."""
    if _under_grad(q, k, v):
        return _FusedAttention.apply(q, k, v)
    if q.device.type == "cpu":
        return fused_attention_ref(q, k, v)
    return _fwd_kernel(q, k, v, None, want_lse=False)[0]
