"""FSDP (ZeRO-3) parameter sharding over the data axis.

Port of ``genhancer_tpu/parallel/fsdp.py``.  With ``fsdp: true`` every
parameter leaf (trainable and frozen) of at least ``fsdp_min_size``
elements keeps only the rank's ``1/dp`` block of its largest free
dimension that divides the data axis (``fsdp_spec``; composed with the TP
spec, whose dimension is not free).  JAX states this as placements and XLA
inserts the collectives; here:

  * a sharded leaf is gathered over the data axis at each read of it
    (``shard_leaf``: the module's attribute is the gathered tensor) and
    freed when its use ends; a read inside ``torch.utils.checkpoint`` (the
    DiT's remat) runs the gather again in the recompute;
  * the gathered tensor's gradient is reduce-scattered over the data axis
    (``_Gather``'s backward), so the leaf's ``.grad`` is the rank's block
    of the global batch's gradient and takes no further all-reduce; a leaf
    whose gradient every rank computes whole (``whole_grad``: the int8 dW
    of the global rows, ``core.quant``) keeps its block of it instead;
  * the optimizer updates the rank's block: its moments live on the block,
    so FSDP implies ZeRO-1 for those leaves (``mesh.row_range`` is not
    applied to them, as JAX's ``shard_over_data`` skips sharded leaves).
    Leaves under ``fsdp_min_size`` stay replicated and take DP's
    all-reduce.

Under FSDP the optimizer is the default chain only (``validate_fsdp``).
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from . import mesh
from .mesh import DATA_AXIS

# leaves below this many elements stay replicated (a 64-wide bias shard
# saves ~nothing and adds an all-gather dispatch per step)
MIN_SHARD_SIZE = 2 ** 16


def fsdp_spec(leaf, n: int, base=(), min_size: int = MIN_SHARD_SIZE):
    """The spec (a tuple of axis names, trailing replicated dims trimmed)
    sharding ``leaf``'s largest free dim over the data axis.

    ``base`` is an existing (TP) spec whose axes are preserved; dims it
    already shards are not candidates.  Returns ``base`` unchanged when no
    dim divides ``n`` or the leaf is below ``min_size``.  ``leaf`` is
    anything with a ``shape``."""
    shape = tuple(getattr(leaf, "shape", ()))
    nd = len(shape)
    spec = list(base) + [None] * (nd - len(tuple(base)))

    def norm(s):     # (None, None) -> (): trim trailing replicated dims
        while s and s[-1] is None:
            s = s[:-1]
        return tuple(s)

    if nd == 0 or int(math.prod(shape)) < min_size:
        return norm(spec)
    cands = [d for d in range(nd)
             if spec[d] is None and shape[d] % n == 0 and shape[d] >= n]
    if not cands:
        return norm(spec)
    d = max(cands, key=lambda d: shape[d])
    spec[d] = DATA_AXIS
    return norm(spec)


def validate_fsdp(cfg) -> None:
    """Reject compositions FSDP does not support (JAX's messages).

    * pipeline parallelism stacks per-stage params (parallel/pp.py);
    * the fused optimizer is refused as in JAX, whose fused kernel would
      gather each sharded param at the update; the default chain is
      elementwise and updates the rank's block."""
    if int(cfg.get("pipeline_parallel", 1) or 1) > 1:
        raise ValueError("fsdp does not compose with pipeline_parallel "
                         "(stage stacking owns the param placement)")
    if int(cfg.get("sequence_parallel", 1) or 1) > 1:
        raise ValueError("fsdp does not compose with sequence_parallel "
                         "(the attention anchor does not cover the ring "
                         "path); use shard_optimizer_state with SP")
    if cfg.get("fused_optimizer") == "pallas":
        raise ValueError(
            "fsdp requires the default optax optimizer: the fused Pallas "
            "AdamW would force an all-gather of each sharded param at the "
            "update (no custom_partitioning on the kernel); drop "
            "fused_optimizer or fsdp")


class _Gather(torch.autograd.Function):
    """The data axis's blocks of a leaf concatenated along ``dim``; the
    gradient reduce-scattered back to the rank's block (``whole``: the
    gradient is the global one on every rank already, and the rank keeps
    its block of it)."""

    @staticmethod
    def forward(ctx, block, dim, whole):
        ctx.dim, ctx.whole = dim, whole
        return mesh.all_gather_dim(block, dim, DATA_AXIS)

    @staticmethod
    def backward(ctx, g):
        if ctx.whole:
            n = g.shape[ctx.dim] // mesh.data_size()
            return g.narrow(ctx.dim, mesh.data_rank() * n, n).contiguous(), None, None
        return mesh.reduce_scatter_dim(g, ctx.dim, DATA_AXIS), None, None


def gather(block: torch.Tensor, dim: int, whole: bool = False) -> torch.Tensor:
    return _Gather.apply(block, dim, whole)


class _Sharded:
    """Mixed into a module that holds FSDP blocks: reading one of them
    (``_fsdp_dims`` names it and its dim) returns it gathered over the data
    axis.  The block stays the parameter or buffer under its own name, so
    ``named_parameters`` and ``state_dict`` list the rank's blocks."""

    def __getattr__(self, name):
        dims = self.__dict__.get("_fsdp_dims")
        if dims is not None and name in dims:
            leaf = self._parameters[name] if name in self._parameters else self._buffers[name]
            return gather(leaf, dims[name], name in self.__dict__.get("_fsdp_whole", ()))
        return super().__getattr__(name)


_CLASSES: Dict[type, type] = {}


def shard_leaf(module: torch.nn.Module, name: str, dim: int) -> None:
    """Read ``module.<name>`` (already the rank's block along ``dim``)
    gathered over the data axis from now on."""
    cls = type(module)
    if not issubclass(cls, _Sharded):
        if cls not in _CLASSES:
            _CLASSES[cls] = type(f"FSDP{cls.__name__}", (_Sharded, cls), {})
        module.__class__ = _CLASSES[cls]
        object.__setattr__(module, "_fsdp_dims", {})
    module._fsdp_dims[name] = dim


def whole_grad(module: torch.nn.Module, name: str) -> None:
    """The FSDP leaf ``module.<name>`` takes a gradient that every rank
    computes whole: its gather keeps the rank's block of it."""
    whole = module.__dict__.get("_fsdp_whole")
    if whole is None:
        whole = set()
        object.__setattr__(module, "_fsdp_whole", whole)
    whole.add(name)
