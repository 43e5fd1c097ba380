"""Tensor parallelism for the DiT: Megatron's layout on the model axis.

Port of ``genhancer_tpu/parallel/tp.py``.  JAX states the layout as
``NamedSharding``s and lets XLA derive the collectives; here each rank
keeps its slice of every sharded leaf and the forward calls the
collectives itself:

  * column-parallel producers (``qkv`` [3h, h], ``mlp.0`` [m, h], the single
    blocks' fused ``linear1`` [3h+m, h]) keep the output rows of the rank's
    heads and MLP slice, their biases with them; their input passes
    ``copy_to_model`` (identity forward, all-reduce of the gradient over
    the model axis backward);
  * row-parallel consumers (``proj`` [h, h], ``mlp.2`` [h, m], ``linear2``
    [h, h+m]) keep the matching input columns; their product passes
    ``reduce_from_model`` (all-reduce forward, identity backward), and
    their bias, replicated, is added once, after it;
  * everything else is replicated.  The QK-norm scales are replicated but
    act on the rank's heads only, so their gradients are partial sums over
    the model axis (``partial_over_model``).

Attention then runs on ``H / tp`` local heads.  The head split differs from
JAX's: JAX shards ``qkv`` and ``linear1`` in contiguous row blocks and XLA
reshards around the head split, while here each rank keeps the q, k and v
rows of the same heads (``model_index``), so no activation moves; the
checkpoint, the optimizer state and ``weights.convert`` gather back to the
reference order.  The int8 paths (``core.quant``) keep JAX's codes: a row
that spans the model axis takes the whole row's amax, and the int32
products are summed over the model axis before they are dequantized.

``_TP_RULES`` match JAX's grouped paths (``double_blocks.N.img.attn.qkv``);
the port's leaves carry the reference's names (``double_blocks.N.img_attn.
qkv``, ``img_mlp.0``), which ``jax_path`` translates first.
"""

from __future__ import annotations

import re
from typing import Optional, Sequence, Tuple

import torch

from . import mesh
from .mesh import MODEL_AXIS

# JAX's PartitionSpecs as tuples of axis names; () is replicated
Spec = Tuple[Optional[str], ...]

# flat-path regex -> (weight spec, bias spec)
_COL = ((MODEL_AXIS, None), (MODEL_AXIS,))      # shard output dim
_ROW = ((None, MODEL_AXIS), ())                 # shard input dim
_TP_RULES = [
    (re.compile(r"double_blocks\.\d+\.(img|txt)\.attn\.qkv\."), _COL),
    (re.compile(r"double_blocks\.\d+\.(img|txt)\.attn\.proj\."), _ROW),
    (re.compile(r"double_blocks\.\d+\.(img|txt)\.mlp\.0\."), _COL),
    (re.compile(r"double_blocks\.\d+\.(img|txt)\.mlp\.2\."), _ROW),
    (re.compile(r"single_blocks\.\d+\.linear1\."), _COL),
    (re.compile(r"single_blocks\.\d+\.linear2\."), _ROW),
]
# replicated leaves that act on the rank's heads: their gradients are partial
_PARTIAL = re.compile(r"(^|\.)norm\.(query|key)_norm\.scale$")


def jax_path(path: str) -> str:
    """A DiT leaf's path under the port's (the reference's) names ->
    JAX's grouped path: ``double_blocks.N.img_attn.qkv`` ->
    ``double_blocks.N.img.attn.qkv``."""
    parts = path.split(".")
    if len(parts) > 2 and parts[0] == "double_blocks" and "_" in parts[2]:
        stream, _, sub = parts[2].partition("_")
        return ".".join(parts[:2] + [stream, sub] + parts[3:])
    return path


def dit_param_spec(path: str, leaf) -> Spec:
    """The spec of one flat DiT param path, JAX's grouped path (() =
    replicated).

    Static-int8 factor leaves (``weight_q`` [o, i] + ``w_scale`` [o, 1],
    ``core.quant.quantize_lora_base``) shard like the weight they stand
    for: ``weight_q`` takes the weight spec; the per-output-row ``w_scale``
    shards with the output dim (replicated for row-parallel consumers,
    whose sharded dim is the input)."""
    for pat, (w_spec, b_spec) in _TP_RULES:
        if pat.search(path):
            nd = len(getattr(leaf, "shape", ()))
            if path.endswith(".weight") and nd == 2:
                return w_spec
            if path.endswith(".weight_q") and nd == 2:
                return w_spec
            if path.endswith(".w_scale") and nd == 2:
                return _norm((w_spec[0], None))
            if path.endswith(".bias") and nd == 1:
                return b_spec
            break
    return ()


def _norm(spec) -> Spec:
    spec = tuple(spec)
    while spec and spec[-1] is None:
        spec = spec[:-1]
    return spec


def port_spec(path: str, leaf) -> Spec:
    """``dit_param_spec`` of a leaf under the port's names (the path below
    ``dit.``)."""
    return dit_param_spec(jax_path(path), leaf)


def partial_over_model(path: str) -> bool:
    """Whether a replicated DiT leaf (path below ``dit.``) takes a partial
    gradient on each model rank: the QK-norm scales, which see the rank's
    heads only."""
    return bool(_PARTIAL.search(path))


def validate_tp(dit_cfg, tp: int) -> None:
    if tp <= 1:
        return
    if dit_cfg.num_heads % tp:
        raise ValueError(
            f"num_heads={dit_cfg.num_heads} not divisible by "
            f"model_parallel={tp} (attention heads shard over the model axis)")
    if dit_cfg.hidden_size % tp or dit_cfg.mlp_hidden % tp:
        raise ValueError(
            f"hidden dims ({dit_cfg.hidden_size}, {dit_cfg.mlp_hidden}) must "
            f"divide model_parallel={tp}")


def model_index(path: str, n: int, tp: int, r: int, hidden: int) -> torch.Tensor:
    """The positions along the model-sharded dimension (size ``n``) of a
    DiT leaf that model rank ``r`` of ``tp`` keeps: the q, k and v rows of
    its heads (``qkv``; with its MLP slice, ``linear1``), the matching
    input columns of ``linear2`` (its heads' attention outputs, then its
    MLP slice), a contiguous ``1/tp`` block elsewhere; ``hidden`` is the
    DiT's width."""
    def block(start, size):
        return torch.arange(start + r * (size // tp), start + (r + 1) * (size // tp))

    if ".qkv." in path:
        return torch.cat([block(s * (n // 3), n // 3) for s in range(3)])
    if ".linear1." in path:
        return torch.cat([block(s * hidden, hidden) for s in range(3)]
                         + [block(3 * hidden, n - 3 * hidden)])
    if ".linear2." in path:
        return torch.cat([block(0, hidden), block(hidden, n - hidden)])
    return block(0, n)


# ---------------------------------------------------------------------------
# the f and g functions of Megatron's column- and row-parallel pair
# ---------------------------------------------------------------------------

class _CopyToModel(torch.autograd.Function):
    """Identity forward; the gradient summed over the model axis."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return mesh.all_reduce_(g.contiguous().clone(), MODEL_AXIS)


class _ReduceFromModel(torch.autograd.Function):
    """The partial products summed over the model axis; identity backward."""

    @staticmethod
    def forward(ctx, x):
        return mesh.all_reduce_(x.contiguous().clone(), MODEL_AXIS)

    @staticmethod
    def backward(ctx, g):
        return g


def copy_to_model(x: torch.Tensor) -> torch.Tensor:
    return _CopyToModel.apply(x) if mesh.model_size() > 1 else x


def reduce_from_model(x: torch.Tensor) -> torch.Tensor:
    return _ReduceFromModel.apply(x) if mesh.model_size() > 1 else x


def whole_shape(shape: Sequence[int], mode: Optional[str]) -> Tuple[int, int]:
    """The whole [out, in] of a weight whose rank's slice has ``shape``
    (``mode`` "col": its rows, "row": its columns, None: all of it)."""
    o, i = shape
    n = mesh.model_size()
    return (o * n, i) if mode == "col" else (o, i * n) if mode == "row" else (o, i)

