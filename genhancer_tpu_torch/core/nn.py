"""Neural-net primitives: parameter-holding modules and the functions that
apply them.

Port of ``genhancer_tpu/core/nn.py``.  Each JAX ``(init,
apply)`` pair becomes an ``nn.Module`` that holds the parameters under the
reference torch names (``weight``/``bias``/``scale``, linear weights
``[out, in]``, conv weights OIHW) plus an apply function with the JAX name
and signature ``f(p, x)``, so the two packages read side by side.

Int8 (``core.quant``): ``Int8Layer`` is a frozen linear or conv that tree
surgery quantized; ``linear``/``conv2d`` dispatch on it, and ``linear`` runs
the int8 base of any module carrying ``weight_q`` (QLoRA's kept-weight
modules too).  Inside
``int8_training_ctx`` every ``linear`` whose smaller dimension reaches
``quant.SWITCHBACK_MIN_DIM`` runs SwitchBack, reading the
optimizer-maintained int8 copy of its weight from the non-persistent buffers
``weight_sb_q``/``weight_sb_scale`` when ``train.state.with_quant_cache`` has
set them.

LoRA (``train.lora``): a wrapped linear carries ``lora_A`` [r, in],
``lora_B`` [out, r] and the buffer ``lora_scale``; ``linear`` adds the
low-rank branch after the base product and before the bias, and inside
``lora_dropout_ctx`` drops the branch's input.

Compute policy (as in JAX): matmuls run in the activation dtype with the
weight cast at use; normalisation statistics are float32, and layernorm /
rmsnorm then normalise in the input dtype.

Random init draws from an explicit ``torch.Generator`` with the JAX
package's distributions (``init_weights``); there is no global RNG use.
"""

from __future__ import annotations

import contextlib
import functools
import math
import threading
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel import tp as tp_m
from ..parallel.mesh import rand_rows


def _param(shape, device, dtype) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, device=device,
                                    dtype=dtype or torch.float32))


def init_weights(root: nn.Module, generator: torch.Generator) -> nn.Module:
    """Fill every parameter of ``root`` from ``generator`` — each module that
    owns parameters directly defines ``init_(generator)``."""
    with torch.no_grad():
        for m in root.modules():
            if hasattr(m, "init_"):
                m.init_(generator)
    return root


# ---------------------------------------------------------------------------
# linear
# ---------------------------------------------------------------------------

class Linear(nn.Module):
    """``y = x @ weight.T + bias`` with ``weight`` [out, in]."""

    def __init__(self, in_dim: int, out_dim: int, bias: bool = True, *,
                 device=None, dtype=None):
        super().__init__()
        self.in_dim = in_dim
        self.weight = _param((out_dim, in_dim), device, dtype)
        self.bias = _param((out_dim,), device, dtype) if bias else None

    def init_(self, g: torch.Generator):
        # torch.nn.Linear defaults: kaiming-uniform weight, uniform bias
        bound_w = math.sqrt(1.0 / self.in_dim) * math.sqrt(3.0)
        self.weight.uniform_(-bound_w, bound_w, generator=g)
        if self.bias is not None:
            bound_b = math.sqrt(1.0 / self.in_dim)
            self.bias.uniform_(-bound_b, bound_b, generator=g)


class ZeroLinear(Linear):
    """A linear whose weight (and bias) start at zero: the ControlNet's and
    the IP-Adapter's zero-init projections."""

    def init_(self, g):
        self.weight.zero_()
        if self.bias is not None:
            self.bias.zero_()


class Int8Layer(nn.Module):
    """A frozen linear or conv as int8 factors, the JAX tree's leaves:
    ``weight_q`` int8 and ``w_scale`` float32 buffers (state-dict keys) and
    the kept ``bias``; no float weight.  A linear holds ``weight_q`` [out, in]
    with ``w_scale`` [out, 1], a conv ``weight_q`` OIHW with ``w_scale``
    [1, 1, 1, O]."""

    def __init__(self, weight_q: torch.Tensor, w_scale: torch.Tensor,
                 bias: Optional[nn.Parameter] = None):
        super().__init__()
        self.register_buffer("weight_q", weight_q)
        self.register_buffer("w_scale", w_scale)
        self.bias = bias


# the SwitchBack context's dW kind ("bf16", "int8_dw" or "cols") while open
_INT8_TRAIN = threading.local()


@contextlib.contextmanager
def int8_training_ctx(full: bool = False, dw_int8: bool = False):
    """Route every ``linear`` with min(out, in) >= ``quant.SWITCHBACK_MIN_DIM``
    (the constant the cache's layer set reads) through SwitchBack: dW in
    float32 products by default, per-column int8 with ``full``, K8's
    per-block int8 with ``dw_int8``."""
    prev = getattr(_INT8_TRAIN, "dw", None)
    _INT8_TRAIN.dw = "cols" if full else ("int8_dw" if dw_int8 else "bf16")
    try:
        yield
    finally:
        _INT8_TRAIN.dw = prev


def int8_ctx_replay(fn):
    """``fn`` as a function whose every call runs in the SwitchBack context
    open when it was made, for a function that ``torch.utils.checkpoint``
    runs again in the backward (the DiT's remat), where the forward's
    ``int8_training_ctx`` has closed — and on autograd's own thread, which
    never saw it.  Outside the context ``fn`` is returned."""
    dw = getattr(_INT8_TRAIN, "dw", None)
    if dw is None:
        return fn

    def run(*args):
        prev = getattr(_INT8_TRAIN, "dw", None)
        _INT8_TRAIN.dw = dw
        try:
            return fn(*args)
        finally:
            _INT8_TRAIN.dw = prev

    return run


# the LoRA dropout context while open: {"generator", "rate", "masks", "calls"}
_LORA_DROPOUT = threading.local()


@contextlib.contextmanager
def lora_dropout_ctx(generator: Optional[torch.Generator], rate: float,
                     masks: Optional[List[torch.Tensor]] = None):
    """Drop the input of every LoRA branch ``linear`` runs inside the block
    (peft's ``nn.Dropout`` on the A-branch, ``nn.py:84-92``): one keep-mask
    per wrapped call, in call order, drawn from ``generator`` — or, from a
    test, the i-th of ``masks`` (bool, the input's shape) for the i-th call."""
    prev = getattr(_LORA_DROPOUT, "state", None)
    _LORA_DROPOUT.state = {"generator": generator, "rate": float(rate),
                           "masks": masks, "calls": 0}
    try:
        yield
    finally:
        _LORA_DROPOUT.state = prev


def lora_dropout_replay(fn):
    """``fn`` as a function whose every call draws the LoRA dropout masks of
    its first call, for a function that ``torch.utils.checkpoint`` runs again
    in the backward (``tower_remat``).  The checkpoint restores the global
    RNG, not the context's generator, and the context may be closed by then:
    a later call reopens the first call's context at its first call's index
    and, where the masks come from the generator, its state (put back after),
    as JAX's ``jax.checkpoint`` replays the same ``fold_in(key, call)``
    keys.  Outside an open context with a nonzero rate ``fn`` is returned."""
    ctx = getattr(_LORA_DROPOUT, "state", None)
    if ctx is None or ctx["rate"] <= 0.0:
        return fn
    gen = ctx["generator"] if ctx["masks"] is None else None
    first = {}

    def run(*args):
        if not first:
            first.update(calls=ctx["calls"], gen=gen.get_state() if gen is not None else None)
            return fn(*args)
        prev, now = getattr(_LORA_DROPOUT, "state", None), None
        _LORA_DROPOUT.state = {**ctx, "calls": first["calls"]}
        if gen is not None:
            now = gen.get_state()
            gen.set_state(first["gen"])
        try:
            return fn(*args)
        finally:
            _LORA_DROPOUT.state = prev
            if gen is not None:
                gen.set_state(now)

    return run


def _lora_dropout(x: torch.Tensor) -> torch.Tensor:
    """``_lora_dropout`` (``nn.py:95-103``): kept elements divided by keep_p
    rounded to x.dtype (bf16 0.9 is 0.8984375), dropped ones zero."""
    ctx = getattr(_LORA_DROPOUT, "state", None)
    if ctx is None or ctx["rate"] <= 0.0:
        return x
    keep_p = 1.0 - ctx["rate"]
    if ctx["masks"] is not None:
        keep = ctx["masks"][ctx["calls"]]
    else:
        # data parallel: this rank's rows of the global batch's mask
        keep = rand_rows(x.shape, ctx["generator"], x.device) < keep_p
    ctx["calls"] += 1
    return torch.where(keep, x / _device_scalar(keep_p, x.dtype, x.device), 0.0)


@functools.lru_cache(maxsize=None)
def _device_scalar(value: float, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """``value`` rounded to ``dtype`` as a 0-d tensor on ``device``: CUDA
    divides by a host scalar as a product with its reciprocal, by a device
    tensor exactly, as the CPU and JAX do."""
    with torch.inference_mode(False):
        return torch.tensor(value, dtype=dtype).to(device)


def linear(p, x: torch.Tensor) -> torch.Tensor:
    """x: [..., in] -> [..., out] in x.dtype.  The bias is added after the
    matmul has been rounded to x.dtype, as the JAX version does.  A module
    carrying ``weight_q`` (an ``Int8Layer``, or QLoRA's kept-weight module)
    runs the int8 base product, inside ``int8_training_ctx`` too; else
    inside that context a large enough ``Linear`` runs SwitchBack
    (``nn.py:124-173``).  ``p`` may be any module with a 2-D ``weight`` (and
    optionally ``bias``).

    A LoRA-wrapped ``p`` adds ``up * scale`` with ``down = dropout(x) @ A.T``
    and ``up = down @ B.T`` before the bias, each product and the scaled
    branch rounded to x.dtype, the scale cast to x.dtype first
    (``nn.py:164-169``).

    Tensor parallel (``p.tp_mode``, ``parallel.tp``): a column-parallel
    ``p`` holds the rank's output rows (and bias) and its input passes
    ``copy_to_model``; a row-parallel one holds the rank's input columns,
    its product is summed over the model axis (``reduce_from_model``) and
    the whole bias added after.  The int8 products do their own sums, in
    int32 (``core.quant``), and the SwitchBack gate reads the whole
    weight's shape."""
    from . import quant
    tp = getattr(p, "tp_mode", None)
    if getattr(p, "weight_q", None) is not None:
        y = quant.linear_int8_base(p, x)
    else:
        w = p.weight.to(x.dtype)
        dw = getattr(_INT8_TRAIN, "dw", None)
        if dw is not None and min(tp_m.whole_shape(w.shape, tp)) >= quant.SWITCHBACK_MIN_DIM:
            y = quant.switchback(x, w, getattr(p, "weight_sb_q", None),
                                 getattr(p, "weight_sb_scale", None), dw=dw,
                                 **({"tp": tp} if tp else {}))
        else:
            if tp == "col":
                x = tp_m.copy_to_model(x)
            y = torch.matmul(x, w.t())
            if tp == "row":
                y = tp_m.reduce_from_model(y)
    lora_a = getattr(p, "lora_A", None)
    if lora_a is not None:
        down = torch.matmul(_lora_dropout(x), lora_a.to(x.dtype).t())
        up = torch.matmul(down, p.lora_B.to(x.dtype).t())
        y = y + up * p.lora_scale.to(x.dtype)
    bias = getattr(p, "bias", None)
    if bias is not None:
        y = y + bias.to(x.dtype)
    return y


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

class LayerNorm(nn.Module):
    def __init__(self, dim: int, *, device=None, dtype=None):
        super().__init__()
        self.weight = _param((dim,), device, dtype)
        self.bias = _param((dim,), device, dtype)

    def init_(self, g):
        self.weight.fill_(1.0)
        self.bias.zero_()


def layernorm(p: Optional[LayerNorm], x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """LayerNorm over the last dim: float32 mean/variance, normalisation in
    x.dtype; affine iff ``p`` is given.  (``F.layer_norm`` rounds differently
    in bf16.)"""
    xf = x.to(torch.float32)
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    inv = torch.rsqrt(var + eps)
    y = (x - mu.to(x.dtype)) * inv.to(x.dtype)
    if p is not None:
        y = y * p.weight.to(x.dtype) + p.bias.to(x.dtype)
    return y


class RMSNorm(nn.Module):
    def __init__(self, dim: int, *, device=None, dtype=None):
        super().__init__()
        self.scale = _param((dim,), device, dtype)

    def init_(self, g):
        self.scale.fill_(1.0)


def rmsnorm(p: RMSNorm, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm: float32 mean square, normalisation in x.dtype."""
    ms = x.to(torch.float32).square().mean(dim=-1, keepdim=True)
    inv = torch.rsqrt(ms + eps).to(x.dtype)
    return (x * inv) * p.scale.to(x.dtype)


class GroupNorm(nn.Module):
    def __init__(self, channels: int, *, device=None, dtype=None):
        super().__init__()
        self.weight = _param((channels,), device, dtype)
        self.bias = _param((channels,), device, dtype)

    def init_(self, g):
        self.weight.fill_(1.0)
        self.bias.zero_()


def groupnorm(p: GroupNorm, x: torch.Tensor, num_groups: int = 32,
              eps: float = 1e-6) -> torch.Tensor:
    """GroupNorm over NCHW input; float32 statistics and affine, result in
    x.dtype.  Groups clamp to the channel count (tiny test configs)."""
    n, c, h, w = x.shape
    num_groups = min(num_groups, c)
    xf = x.to(torch.float32).reshape(n, num_groups, c // num_groups, h, w)
    mu = xf.mean(dim=(2, 3, 4), keepdim=True)
    var = (xf - mu).square().mean(dim=(2, 3, 4), keepdim=True)
    y = ((xf - mu) * torch.rsqrt(var + eps)).reshape(n, c, h, w)
    y = (y * p.weight.to(torch.float32)[:, None, None]
         + p.bias.to(torch.float32)[:, None, None])
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# conv
# ---------------------------------------------------------------------------

class Conv2d(nn.Module):
    """Conv weights OIHW (the reference torch layout)."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int, bias: bool = True, *,
                 device=None, dtype=None):
        super().__init__()
        self.fan_in = in_ch * kernel * kernel
        self.weight = _param((out_ch, in_ch, kernel, kernel), device, dtype)
        self.bias = _param((out_ch,), device, dtype) if bias else None

    def init_(self, g):
        bound = math.sqrt(1.0 / self.fan_in) * math.sqrt(3.0)
        self.weight.uniform_(-bound, bound, generator=g)
        if self.bias is not None:
            bound_b = math.sqrt(1.0 / self.fan_in)
            self.bias.uniform_(-bound_b, bound_b, generator=g)


def conv2d(p, x: torch.Tensor, stride: int = 1,
           padding: Optional[int] = None) -> torch.Tensor:
    """NCHW conv in x.dtype.  ``padding=None`` is XLA's "SAME" for the odd
    kernels at stride 1 this package uses (k // 2 on each side).  An
    ``Int8Layer`` runs the int8 product (``core.quant.conv2d_int8``)."""
    if isinstance(p, Int8Layer):
        from .quant import conv2d_int8
        return conv2d_int8(p, x, stride=stride, padding=padding)
    w, b = p.weight, p.bias       # each read once: an FSDP leaf gathers at a read
    pad = w.shape[-1] // 2 if padding is None else padding
    return F.conv2d(x, w.to(x.dtype), b.to(x.dtype) if b is not None else None,
                    stride=stride, padding=pad)


# ---------------------------------------------------------------------------
# activations
# ---------------------------------------------------------------------------

def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


def gelu_exact(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x)


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    """x * sigmoid(1.702 x) — OpenAI CLIP's activation."""
    return x * torch.sigmoid(as_dtype_scalar(1.702, x.dtype) * x)


def silu(x: torch.Tensor) -> torch.Tensor:
    return F.silu(x)


ACTIVATIONS = {
    "gelu_tanh": gelu_tanh,
    "gelu_pytorch_tanh": gelu_tanh,
    "gelu": gelu_exact,
    "gelu_new": gelu_tanh,
    "quick_gelu": quick_gelu,
    "silu": silu,
}


# ---------------------------------------------------------------------------
# composite layers of the DiT
# ---------------------------------------------------------------------------

class MLPEmbedder(nn.Module):
    def __init__(self, in_dim: int, hidden: int, *, device=None, dtype=None):
        super().__init__()
        self.in_layer = Linear(in_dim, hidden, device=device, dtype=dtype)
        self.out_layer = Linear(hidden, hidden, device=device, dtype=dtype)


def mlp_embedder(p: MLPEmbedder, x: torch.Tensor) -> torch.Tensor:
    return linear(p.out_layer, silu(linear(p.in_layer, x)))


def timestep_embedding(t: torch.Tensor, dim: int, max_period: float = 10_000.0,
                       time_factor: float = 1000.0) -> torch.Tensor:
    """Sinusoidal embedding, [cos | sin] order.  ``time_factor * t`` is taken
    in t's dtype (bf16 on the serving path) before the float32 cast, as the
    JAX version does."""
    t = (t * as_dtype_scalar(time_factor, t.dtype)).to(torch.float32)
    args = t[:, None] * _timestep_freqs(dim // 2, max_period, t.device)[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


@functools.lru_cache(maxsize=None)
def _timestep_freqs(half: int, max_period: float, device: torch.device) -> torch.Tensor:
    """The embedding's float32 frequencies, computed on the host and copied to
    ``device`` once: a device's ``exp`` may round an entry one ulp away from
    the host's, and at arguments up to 1000 * t that moves the embedding, and
    every gradient downstream of it, by about 1e-4 relative.  Built outside
    inference mode, so that training may reuse what serving cached."""
    with torch.inference_mode(False):
        freqs = torch.exp(-math.log(max_period) * torch.arange(half, dtype=torch.float32) / half)
        return freqs.to(device)


def as_dtype_scalar(x: float, dtype: torch.dtype) -> float:
    """A Python scalar rounded to ``dtype`` — JAX rounds weakly-typed
    constants to the array's dtype, while torch keeps them in float32 math."""
    return float(torch.tensor(x, dtype=dtype))


class Modulation(nn.Module):
    def __init__(self, dim: int, double: bool, *, device=None, dtype=None):
        super().__init__()
        self.double = double
        self.lin = Linear(dim, (6 if double else 3) * dim, device=device, dtype=dtype)


def modulation(p: Modulation, vec: torch.Tensor
               ) -> List[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]:
    """vec [B, D] -> list of (shift, scale, gate) triples, each [B, 1, D]."""
    out = linear(p.lin, silu(vec))[:, None, :]
    chunks = out.chunk(6 if p.double else 3, dim=-1)
    return [tuple(chunks[i:i + 3]) for i in range(0, len(chunks), 3)]
