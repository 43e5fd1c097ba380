"""Int8 quantization: the frozen tower and VAE encoder, and SwitchBack int8
training of the DiT.

Port of ``genhancer_tpu/core/quant.py``.

Scheme (weight-static, activation-dynamic): weights are symmetric int8 per
output channel, ``w_q = clip(round(w / s_w))`` with ``s_w = max|w[o]| / 127``;
activations are quantized dynamically, per row (the last dim) for linears —
K7, ``core.kernels.rowquant`` — and per tensor for convs; the int8 products
accumulate exactly in int32 (``torch._int_mm``, through
``core.kernels.int8_mm.int_mm``; a convolution is im2col + ``_int_mm``) and
are dequantized with the scales in the JAX package's association order:
linear forward ``(acc * sx) * ws``, conv ``acc * (sx * ws)``, dx
``acc * sg``, dW over columns ``(acc * sg^T) * sx``; the result is cast to
the input's dtype and the bias added in that dtype.

The JAX ``custom_vjp`` functions become ``torch.autograd.Function``s:
``_Int8Matmul`` (the straight-through estimator of a frozen int8 linear)
and ``_SwitchBack`` (``switchback``: ``switchback_linear`` and its five
variants — the weight quantized in the forward or read from the
optimizer-maintained cache, times a bf16 dW, the per-block int8 dW of K8,
or the per-column int8 dW).  Module surgery replaces ``Linear``/``Conv2d``
modules by ``core.nn.Int8Layer``, which holds ``weight_q`` and ``w_scale``
buffers and no float weight, on the layers the JAX tree surgery selects.

QLoRA (stage 2, ``quantize_lora_base``) keeps the float ``weight`` and adds
``weight_q``/``w_scale`` beside it as non-persistent buffers of the same
module: ``core.nn.linear`` runs the int8 base from them, ``train.lora``
merges into the kept weight, and no state dict (checkpoint ``.bin``, HF
export) carries them; ``refresh_static_quant_flat`` re-derives them after a
load has replaced the masters.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn as tnn

from ..parallel import mesh, ring
from ..parallel.mesh import DATA_AXIS, MODEL_AXIS, SEQ_AXIS
from ..parallel.tp import whole_shape
from . import nn
from .kernels import int8_dw as K8
from .kernels import rowquant as K7
from .kernels.int8_mm import int_mm
from .kernels.rowquant import div127

f32 = torch.float32


def quantize_weight(w: torch.Tensor, axis: int = 0, group: Optional[str] = None):
    """Per-output-channel symmetric int8; ``axis`` keeps its own scale (0 for
    [out, in] linears and OIHW convs), the other axes are reduced.  Returns
    (int8 weights, float32 scales with the reduced axes kept at 1).
    ``group``: the mesh axis the reduced axes span (a row-parallel weight's
    columns): the amax is the whole channel's."""
    axis %= w.dim()
    wf = w.to(f32)
    amax = wf.abs().amax(dim=tuple(i for i in range(w.dim()) if i != axis), keepdim=True)
    if group is not None:
        mesh.all_reduce_max(amax, group)
    scale = div127(torch.clamp_min(amax, 1e-12))
    return torch.clamp(torch.round(wf / scale), -127, 127).to(torch.int8), scale


def quantize_activation_rows(x: torch.Tensor, col_scale: Optional[torch.Tensor] = None,
                             group: Optional[str] = None):
    """Per-row (last dim) symmetric dynamic quant through K7: (int8, float32
    [..., 1]).  ``col_scale``: optional [C] float32 multiplier folded in first
    (the backward's ``g * ws``).

    ``group``: the mesh axis the rows span (the rank holds a block of each
    row's columns): each row is quantized against the whole row's amax, as
    one process quantizes it.  K7 runs on the rank's columns and a block of
    8 more whose first holds that amax (an element's magnitude, exact in
    x's dtype; with ``col_scale`` the float32 products, as K7 forms them)."""
    c = x.shape[-1]
    x2, cs = x.reshape(-1, c), None if col_scale is None else col_scale.reshape(c)
    if x2.shape[0] == 0:
        # no rows (a seq rank whose chunk holds none of a stream): nothing
        # to launch; the ranks of a model group hold the same rows alike
        return (x2.new_empty(x.shape, dtype=torch.int8),
                x2.new_empty(x.shape[:-1] + (1,), dtype=f32))
    if group is None or mesh.axis_size(group) == 1:
        q, s = K7.rowquant(x2, cs)
    else:
        if cs is not None:
            x2, cs = x2.to(f32) * cs.to(f32), None
        amax = mesh.all_reduce_max(x2.abs().amax(dim=1).to(f32), group)
        pad = x2.new_zeros((x2.shape[0], 8))
        pad[:, 0] = amax
        q, s = K7.rowquant(torch.cat([x2, pad], dim=1))
        q = q[:, :c].contiguous()
    return q.reshape(x.shape), s.reshape(x.shape[:-1] + (1,))


def quantize_activation_tensor(x: torch.Tensor):
    """Per-tensor symmetric dynamic quant (convs): one amax over the whole
    call's batch, never per sample; under data parallelism over the global
    batch (the max over the ranks, as XLA reduces over the data axis)."""
    xf = x.to(f32)
    amax = mesh.all_reduce_max(xf.abs().amax())
    scale = div127(torch.clamp_min(amax, 1e-12))
    return torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8), scale


def _quantize_cols(x2: torch.Tensor, axes=(DATA_AXIS,)):
    """Per-column symmetric quant of a [T, C] matrix -> (int8, float32 [1,
    C]); each column's amax spans the tokens of every rank on ``axes`` (the
    global batch's under data parallelism, every seq rank's under SP).  No
    rows: the amax is 0 there, and the rank still joins the reduction."""
    xf = x2.to(f32)
    amax = (xf.abs().amax(dim=0, keepdim=True) if xf.shape[0]
            else xf.new_zeros((1, xf.shape[1])))
    amax = mesh.all_reduce_max(amax, axes)
    scale = div127(torch.clamp_min(amax, 1e-12))
    return torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8), scale


# ---------------------------------------------------------------------------
# the shared forward and backward blocks (``quant.py:81-132``)
# ---------------------------------------------------------------------------

def _int8_fwd_base(x: torch.Tensor, wq: torch.Tensor, ws: torch.Tensor,
                   tp: Optional[str] = None) -> torch.Tensor:
    """y = x @ dequant(wq, ws)^T: per-row x times per-output-channel W, int32
    accumulation, ``(acc * sx) * ws``.  ``ws``: [out] or [out, 1].

    ``tp`` "row" (a row-parallel weight: x and wq hold the rank's columns,
    ws the whole rows'): x's rows are quantized against the whole row's
    amax and the int32 products summed over the model axis before the
    dequantization, so y is the whole product, with one process's codes.
    "col" (the rank's output rows) needs nothing: x is whole."""
    row = tp == "row"
    xq, sx = quantize_activation_rows(x, group=MODEL_AXIS if row else None)
    acc = int_mm(xq.reshape(-1, x.shape[-1]), wq.t())
    if row:
        mesh.all_reduce_(acc, MODEL_AXIS)
    y = acc.to(f32) * sx.reshape(-1, 1) * ws.reshape(-1)
    return y.reshape(x.shape[:-1] + (wq.shape[0],)).to(x.dtype)


def _int8_dx(g: torch.Tensor, wq: torch.Tensor, ws: torch.Tensor, out_dtype,
             tp: Optional[str] = None) -> torch.Tensor:
    """dx = g @ W with the per-output scales folded into g before its per-row
    quantization (ws is constant along the contraction): ``acc * sg``.

    ``tp`` "col" (g, wq and ws hold the rank's output rows): g's rows are
    quantized against the whole row's amax and the int32 products summed
    over the model axis, so dx is whole.  "row" needs nothing: g is whole
    and dx is the rank's columns."""
    col = tp == "col"
    gq, sg = quantize_activation_rows(g, col_scale=ws.reshape(-1),
                                      group=MODEL_AXIS if col else None)
    acc = int_mm(gq.reshape(-1, g.shape[-1]), wq)
    if col:
        mesh.all_reduce_(acc, MODEL_AXIS)
    return (acc.to(f32) * sg.reshape(-1, 1)).reshape(g.shape[:-1] + (wq.shape[1],)).to(out_dtype)


def _bf16_dw(g: torch.Tensor, x: torch.Tensor, out_dtype) -> torch.Tensor:
    """dW[o, i] = sum_t g[t, o] x[t, i] over the flattened tokens, products
    and sums in float32 (SwitchBack's unquantized weight gradient)."""
    g2, x2 = g.reshape(-1, g.shape[-1]), x.reshape(-1, x.shape[-1])
    return torch.matmul(g2.t().to(f32), x2.to(f32)).to(out_dtype)


def _int8_dw_cols(g: torch.Tensor, x: torch.Tensor, out_dtype,
                  axes=(DATA_AXIS,)) -> torch.Tensor:
    """Full-int8 dW: g and x quantized per column over all tokens,
    ``(acc * sg^T) * sx``.  The rows may be split over ``axes`` (the data
    axis, and the seq axis for a call on token rows under SP): the column
    amaxes span every rank's rows and the int32 products are summed over
    those axes before the dequantization, never after, so every rank holds
    one process's dW of the global rows, bit for bit."""
    gq2, sgc = _quantize_cols(g.reshape(-1, g.shape[-1]), axes)
    xq2, sxc = _quantize_cols(x.reshape(-1, x.shape[-1]), axes)
    acc = mesh.all_reduce_(int_mm(gq2.t(), xq2), axes)
    return ((acc.to(f32) * sgc.t()) * sxc).to(out_dtype)


def global_rows(a: torch.Tensor, split: Optional[str] = None) -> torch.Tensor:
    """The rows of a call's [B, n, C] (or [B, C]) operand on every rank,
    flattened [T, C] in one process's order: the seq ranks' tokens of each
    sample first (``split`` "tokens": the rank holds a chunk of each
    sample's tokens, ``mesh.gather_tokens`` drops the chunks' pad rows),
    then the data ranks' samples in rank order (their batches are the
    global batch's rows in that order).  One process: ``a`` flattened."""
    if split == "tokens":
        a = mesh.gather_tokens(a, SEQ_AXIS)
    return mesh.all_gather_dim(a.reshape(-1, a.shape[-1]), 0, DATA_AXIS)


def _dw(g: torch.Tensor, x: torch.Tensor, out_dtype, shape=None,
        split: Optional[str] = None) -> torch.Tensor:
    """dW through K8 where ``dw_supported`` (the JAX kernel's rule, read on
    the whole weight's ``shape`` [out, in] where the rank holds a slice,
    and on the global rows), else the float32-accumulated dense product
    (``quant.py:282-290``).  K8 runs once on the rows of every rank that
    shares the call (``global_rows``: the data ranks', and the seq ranks'
    for token rows), as GSPMD hands the Pallas call the all-gathered
    operands: its 512-row blocks are the global batch's, and every rank
    holds the global dW.  K8 quantizes per column, so a model rank's
    columns take one process's codes."""
    g2, x2 = global_rows(g, split), global_rows(x, split)
    o, i = shape if shape is not None else (g2.shape[1], x2.shape[1])
    if K8.dw_supported(g2.shape[0], o, i):
        return K8.int8_dw(g2, x2, out_dtype)
    return _bf16_dw(g2, x2, out_dtype)


def row_split(x: torch.Tensor) -> Optional[str]:
    """How a linear's rows lie on the seq axis, read in the forward:
    "tokens" where the ring is open and ``x`` is [B, n, C] (the rank's
    chunk of each sample's tokens), "vector" where it is open and ``x`` is
    [B, C] (the modulation and embedding vectors, whole on every seq rank,
    whose gradient is the rank's tokens' share), else None."""
    if ring.active_scope() is None:
        return None
    return "tokens" if x.dim() == 3 else "vector"


def _seq_total(g: torch.Tensor, split: Optional[str]) -> torch.Tensor:
    """A "vector" call's output gradient summed over the seq axis: the
    whole vector's gradient, which one process quantizes."""
    return mesh.all_reduce_(g.clone(), SEQ_AXIS) if split == "vector" else g


def _count_once(t: Optional[torch.Tensor], split: Optional[str]) -> Optional[torch.Tensor]:
    """A gradient computed from a "vector" call's whole output gradient
    (identical on every seq rank) kept on seq index 0 and zero elsewhere,
    so that the seq sums downstream count it once (exact: x + 0 = x)."""
    if t is None or split != "vector" or mesh.seq_rank() == 0:
        return t
    return torch.zeros_like(t)


# the dW kinds whose SwitchBack gradient is the global one on every rank
GLOBAL_DW = ("int8_dw", "cols")


class _Int8Matmul(torch.autograd.Function):
    """Frozen int8 linear: int8 forward, and the straight-through estimator
    dx = g @ dequant(w) in int8 by scale folding (``_int8_matmul:135``);
    the int8 weights take no gradient."""

    @staticmethod
    def forward(ctx, x, wq, ws, tp):
        ctx.save_for_backward(wq, ws)
        ctx.tp, ctx.split = tp, row_split(x)
        return _int8_fwd_base(x, wq, ws, tp)

    @staticmethod
    def backward(ctx, g):
        wq, ws = ctx.saved_tensors
        g = _seq_total(g, ctx.split)
        return _count_once(_int8_dx(g, wq, ws, g.dtype, ctx.tp), ctx.split), None, None, None


class _SwitchBack(torch.autograd.Function):
    """SwitchBack linear (arXiv:2304.13013, ``quant.py:199-345``): int8
    forward and int8 dx; W quantized in the forward from the master ``w``
    (``wq`` None) or read from the optimizer-maintained cache (``wq``,
    ``ws`` [out]); dW by ``dw`` — "bf16" (float32 products), "int8_dw" (K8)
    or "cols" (per-column int8) — in ``w``'s dtype.  The cache takes no
    gradient.

    Tensor parallel (``tp`` "col" or "row", ``w`` the rank's slice): the
    forward and dx keep one process's codes (``_int8_fwd_base``,
    ``_int8_dx``), a row-parallel W is quantized against its whole rows'
    amax, and each dW kind quantizes per column or sums exact products, so
    the rank's slice of dW is one process's.

    Data and sequence parallel (the rows split over the data axis, and a
    token call's over the seq axis, ``row_split``): the int8 dW kinds
    (``GLOBAL_DW``) are the global rows' dW on every rank — K8 on the
    gathered rows, the per-column kind with its amaxes and int32 sums over
    the axes — and ``train.state.reduce_gradients`` leaves them out of the
    data and seq sums.  A "vector" call (an input whole on every seq rank)
    first sums its output gradient over seq, as one process sees it, and
    its dx (and a float32 dW) count on seq index 0 only."""

    @staticmethod
    def forward(ctx, x, w, wq, ws, dw: str, tp: Optional[str] = None):
        if wq is None:
            wq, ws = quantize_weight(w, axis=0, group=MODEL_AXIS if tp == "row" else None)
        ctx.save_for_backward(x, wq, ws)
        ctx.w_dtype, ctx.dw, ctx.tp = w.dtype, dw, tp
        ctx.shape = whole_shape(w.shape, tp)
        ctx.split = row_split(x)
        return _int8_fwd_base(x, wq, ws, tp)

    @staticmethod
    def backward(ctx, g):
        x, wq, ws = ctx.saved_tensors
        split = ctx.split
        g = _seq_total(g, split)
        dx = _int8_dx(g, wq, ws, x.dtype, ctx.tp) if ctx.needs_input_grad[0] else None
        dw = None
        if ctx.needs_input_grad[1]:
            if ctx.dw == "int8_dw":
                dw = _dw(g, x, ctx.w_dtype, ctx.shape, split)
            elif ctx.dw == "cols":
                dw = _int8_dw_cols(g, x, ctx.w_dtype,
                                   (DATA_AXIS, SEQ_AXIS) if split == "tokens" else (DATA_AXIS,))
            else:
                dw = _count_once(_bf16_dw(g, x, ctx.w_dtype), split)
        return _count_once(dx, split), dw, None, None, None, None


def linear_int8_base(p, x: torch.Tensor) -> torch.Tensor:
    """Base matmul of an int8 linear (no bias — ``core.nn.linear`` adds it);
    a tensor-parallel one (``tp_mode``) returns the whole product."""
    return _Int8Matmul.apply(x, p.weight_q, p.w_scale, getattr(p, "tp_mode", None))


def switchback(x: torch.Tensor, w: torch.Tensor, wq: Optional[torch.Tensor] = None,
               ws: Optional[torch.Tensor] = None, dw: str = "bf16",
               tp: Optional[str] = None) -> torch.Tensor:
    """y = x @ w^T through SwitchBack: the JAX package's six functions are
    ``switchback_linear`` (wq None, dw "bf16"), ``_cached`` (wq, ws given),
    ``_dw``/``_cached_dw`` (dw "int8_dw") and ``_full``/``_full_cached``
    (dw "cols").  ``tp``: ``w`` is the rank's slice of a column- ("col")
    or row-parallel ("row") weight; y is the rank's output columns or the
    whole product, and dx the whole input gradient or the rank's columns."""
    return _SwitchBack.apply(x, w, wq, ws, dw, tp)


def conv2d_int8(p, x: torch.Tensor, stride: int = 1, padding: Optional[int] = None
                ) -> torch.Tensor:
    """NCHW conv of an int8 conv (weight_q OIHW, w_scale [1, 1, 1, O]):
    x quantized per tensor, im2col on the int8 codes (zero padding is exact:
    q(0) = 0), int32 products, ``acc * (sx * ws)``, then x's dtype and the
    bias.  ``padding=None`` is "SAME" for the odd kernels at stride 1."""
    o, c, k, _ = p.weight_q.shape
    pad = k // 2 if padding is None else padding
    xq, sx = quantize_activation_tensor(x)
    xq = xq.permute(0, 2, 3, 1)                                   # NHWC codes
    if pad:
        xq = F.pad(xq, (0, 0, pad, pad, pad, pad))
    b, h, w, _ = xq.shape
    ho, wo = (h - k) // stride + 1, (w - k) // stride + 1
    taps = [xq[:, i:i + stride * (ho - 1) + 1:stride, j:j + stride * (wo - 1) + 1:stride]
            for i in range(k) for j in range(k)]
    cols = torch.stack(taps, dim=-1).reshape(b * ho * wo, c * k * k)   # (c, i, j) order
    acc = int_mm(cols, p.weight_q.reshape(o, c * k * k).t())
    y = (acc.to(f32) * (sx * p.w_scale.reshape(-1))).reshape(b, ho, wo, o)
    y = y.permute(0, 3, 1, 2).to(x.dtype)
    if p.bias is not None:
        y = y + p.bias.to(x.dtype)[:, None, None]
    return y


# ---------------------------------------------------------------------------
# which layers run int8 (``quant.py:348-547``)
# ---------------------------------------------------------------------------

# the one threshold of SwitchBack layers: the forward dispatch
# (core.nn.linear) and the optimizer-maintained cache's layer set
# (switchback_cache_paths) both read it and nothing else, so they cannot
# cover different layers
SWITCHBACK_MIN_DIM = 512

# both in- and out-channels of an int8 VAE encoder conv reach it (a v5e
# measurement, carried over as the config default)
INT8_CONV_MIN_CH = 256

_NOT_LINEAR = ("embedding", "embeddings", "logit_scale", "position_embedding")


def global_dw_paths(flat_params: Dict[str, torch.Tensor], dit_quant: str,
                    layout: Optional[dict] = None) -> Tuple[str, ...]:
    """The trainable leaves whose gradient every rank computes whole
    (``GLOBAL_DW``): the SwitchBack weights of ``int8_dw`` and
    ``int8_full``; none for the other modes."""
    if dit_quant not in ("int8_dw", "int8_full"):
        return ()
    return switchback_cache_paths(flat_params, layout)


def switchback_cache_paths(flat_params: Dict[str, torch.Tensor],
                           layout: Optional[dict] = None) -> Tuple[str, ...]:
    """Flat ``.weight`` paths that the int8 DiT forward routes through
    SwitchBack: the leaves whose int8 copies the optimizer maintains.  The
    gate reads the whole leaf's shape (``layout``: the sharded leaves'
    placements)."""
    layout = layout or {}

    def shape(path, leaf):
        return layout[path].shape if path in layout else tuple(leaf.shape)

    return tuple(sorted(path for path, leaf in flat_params.items()
                        if path.startswith("dit.") and path.endswith(".weight")
                        and leaf.dim() == 2 and min(shape(path, leaf)) >= SWITCHBACK_MIN_DIM))


def quantize_cache(flat_params: Dict[str, torch.Tensor], paths,
                   layout: Optional[dict] = None) -> Dict[str, tuple]:
    """{path: (wq int8 [o, i], ws float32 [o])} for the given .weight paths;
    a sharded weight (``layout``) is quantized whole and the rank keeps its
    block of the codes and of the scales (a collective)."""
    from ..parallel.layout import gather, shard
    layout = layout or {}
    cache = {}
    with torch.no_grad():
        for path in paths:
            pl = layout.get(path)
            wq, ws = quantize_weight(gather(flat_params[path], pl), axis=0)
            cache[path] = (shard(wq, pl), shard(ws[:, 0], pl.like(ws.shape[:1]) if pl else None))
    return cache


def swap_module(root: tnn.Module, path: str, new: tnn.Module) -> None:
    """Put ``new`` in place of the submodule of ``root`` at ``path``."""
    parent, _, name = path.rpartition(".")
    setattr(root.get_submodule(parent) if parent else root, name, new)


def quantize_linear_tree(root: tnn.Module, min_features: int = 64) -> Tuple[str, ...]:
    """Replace, in place, every eligible linear of ``root`` — a module with a
    2-D ``weight`` (``Linear`` or a bare weight such as the CLIP
    ``visual_projection``) whose path names no embedding and whose smaller
    dimension reaches ``min_features`` and which carries no LoRA factors
    (``_eligible_linear:423``: a trainable node is never frozen to int8) —
    by an ``Int8Layer``.  Returns the replaced module paths."""
    done = []
    for path, mod in list(root.named_modules()):
        w = mod._parameters.get("weight")
        if (w is None or w.dim() != 2 or min(w.shape) < min_features
                or getattr(mod, "lora_A", None) is not None
                or any(s in path for s in _NOT_LINEAR)):
            continue
        wq, ws = quantize_weight(w.detach(), axis=0)
        swap_module(root, path, nn.Int8Layer(wq, ws, getattr(mod, "bias", None)))
        done.append(path)
    return tuple(done)


def quantize_conv_tree(root: tnn.Module, min_channels: int = INT8_CONV_MIN_CH
                       ) -> Tuple[str, ...]:
    """Replace, in place, every ``Conv2d`` of ``root`` whose in- and
    out-channels both reach ``min_channels`` by an ``Int8Layer``.  Returns
    the replaced module paths."""
    done = []
    for path, mod in list(root.named_modules()):
        if not isinstance(mod, nn.Conv2d):
            continue
        o, i = mod.weight.shape[:2]
        if min(o, i) < min_channels:
            continue
        wq, ws = quantize_weight(mod.weight.detach(), axis=0)
        swap_module(root, path, nn.Int8Layer(wq, ws.reshape(1, 1, 1, o), mod.bias))
        done.append(path)
    return tuple(done)


def quantize_lora_base(root: tnn.Module, min_features: int = 64) -> Tuple[str, ...]:
    """QLoRA's frozen int8 base (``quantize_lora_base:454``): every module of
    ``root`` holding a 2-D ``weight`` whose smaller dimension reaches
    ``min_features`` and whose path names no embedding — LoRA-wrapped ones
    included — gets ``weight_q`` int8 [out, in] and ``w_scale`` float32
    [out, 1] beside its kept ``weight``, as non-persistent buffers; in
    place.  Returns the module paths."""
    done = []
    for path, mod in root.named_modules():
        w = mod._parameters.get("weight")
        if (w is None or w.dim() != 2 or min(w.shape) < min_features
                or any(s in path for s in _NOT_LINEAR)):
            continue
        wq, ws = quantize_weight(w.detach(), axis=0)
        mod.register_buffer("weight_q", wq, persistent=False)
        mod.register_buffer("w_scale", ws, persistent=False)
        done.append(path)
    return tuple(done)


def static_quant_flat(root: tnn.Module) -> Dict[str, torch.Tensor]:
    """``{flat path: tensor}`` of ``root``'s parameters and buffers, the
    non-persistent ``weight_q``/``w_scale`` included: the flat view
    ``refresh_static_quant_flat`` reads."""
    return {**dict(root.named_parameters()), **dict(root.named_buffers())}


@torch.no_grad()
def refresh_static_quant_flat(flat: Dict[str, torch.Tensor],
                              layout: Optional[dict] = None) -> Tuple[str, ...]:
    """Re-derive every ``*.weight_q``/``*.w_scale`` pair of a flat view
    (``static_quant_flat``) from its kept ``*.weight`` master
    (``refresh_static_quant_flat:495``), writing into the buffers in place —
    needed after a checkpoint load has replaced masters quantized at init.
    A sharded master (``layout``) is quantized whole and each buffer keeps
    the rank's block (a collective).  Returns the refreshed ``.weight``
    paths."""
    from ..parallel.layout import gather, shard
    layout = layout or {}
    done = []
    for path, wq in flat.items():
        if not path.endswith(".weight_q"):
            continue
        wpath = path[: -len("_q")]
        w = flat.get(wpath)
        if w is None:
            continue
        q, s = quantize_weight(gather(w, layout.get(wpath)), axis=0)
        wq.copy_(shard(q, layout.get(path)))
        spath = path[: -len(".weight_q")] + ".w_scale"
        ws, pl = flat[spath], layout.get(spath)
        ws.copy_(shard(s.reshape(pl.shape if pl else ws.shape), pl))
        done.append(path[: -len("_q")])
    return tuple(done)
