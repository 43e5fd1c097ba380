"""Where each leaf lives on the (data, model) mesh: the composition of TP and
FSDP, and the moves between a leaf's whole (reference) layout and the
rank's block of it.

Port of the placement half of ``genhancer_tpu/train/trainer.py:203-240``
(``tp.shard_dit_params`` then ``fsdp.shard_params_fsdp`` with the TP
placements as its base, on trainable and frozen leaves alike).  A
``Placement`` holds a leaf's whole shape, its spec (an axis name or None
per dim) and, on the model axis, the positions the rank keeps
(``tp.model_index``).  ``place(modules, ...)`` replaces each sharded
parameter (and each static-int8 ``weight_q``/``w_scale`` buffer) by the
rank's block, marks the DiT's column- and row-parallel linears
(``tp_mode``) and the FSDP leaves (``fsdp.shard_leaf``), and returns the
layout ``{flat path: Placement}`` of the sharded leaves.  ``shard`` cuts the
rank's block out of a whole tensor (a checkpoint load, a converted
weight), ``gather`` rebuilds the whole one in the reference order (a
collective: every rank of the leaf's axes calls it).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import torch
from torch import nn as tnn

from . import fsdp as fsdp_m
from . import mesh
from . import tp as tp_m
from .mesh import DATA_AXIS, MODEL_AXIS

# the buffers that are leaves of the JAX trees (static int8 factors)
_BUFFER_LEAVES = ("weight_q", "w_scale")


@dataclass(frozen=True, eq=False)
class Placement:
    shape: Tuple[int, ...]                  # the whole leaf's
    spec: Tuple[Optional[str], ...]         # an axis name or None per dim
    index: Optional[torch.Tensor] = None    # the model axis's positions, every rank's

    def dim(self, axis: str) -> Optional[int]:
        return self.spec.index(axis) if axis in self.spec else None

    @property
    def axes(self) -> str:
        """The axis a sum over the leaf's blocks runs on: "model", "data"
        or "world" (both)."""
        m, d = MODEL_AXIS in self.spec, DATA_AXIS in self.spec
        return "world" if m and d else (MODEL_AXIS if m else DATA_AXIS)

    def like(self, shape: Sequence[int]) -> Optional["Placement"]:
        """The placement of a companion tensor of whole ``shape`` that
        shares this leaf's leading dims where their sizes agree (a per-row
        scale [o] or [o, 1]): None where none of them is sharded."""
        spec = tuple(a if d < len(self.shape) and shape[d] == self.shape[d] else None
                     for d, a in enumerate(self.spec[:len(shape)]))
        while spec and spec[-1] is None:
            spec = spec[:-1]
        if not spec:
            return None
        spec += (None,) * (len(shape) - len(spec))
        return Placement(tuple(shape), spec, self.index if MODEL_AXIS in spec else None)


def _mine(index: torch.Tensor) -> torch.Tensor:
    """This model rank's positions, from every rank's in rank order."""
    k = index.numel() // mesh.model_size()
    return index[mesh.model_rank() * k:(mesh.model_rank() + 1) * k]


def shard(full: torch.Tensor, pl: Optional[Placement]) -> torch.Tensor:
    """The rank's block of a whole tensor (contiguous; ``full`` for None)."""
    if pl is None:
        return full
    x = full
    md, dd = pl.dim(MODEL_AXIS), pl.dim(DATA_AXIS)
    if md is not None:
        x = x.index_select(md, _mine(pl.index).to(x.device))
    if dd is not None:
        n = x.shape[dd] // mesh.data_size()
        x = x.narrow(dd, mesh.data_rank() * n, n)
    return x.contiguous()


@torch.no_grad()
def gather(block: torch.Tensor, pl: Optional[Placement]) -> torch.Tensor:
    """The whole tensor, in the reference order, from every rank's block (a
    collective over the placement's axes; ``block`` for None)."""
    if pl is None:
        return block
    x = block
    dd, md = pl.dim(DATA_AXIS), pl.dim(MODEL_AXIS)
    if dd is not None:
        x = mesh.all_gather_dim(x, dd, DATA_AXIS)
    if md is not None:
        parts = mesh.all_gather_dim(x, md, MODEL_AXIS)
        x = torch.empty(pl.shape, dtype=parts.dtype, device=parts.device)
        x.index_copy_(md, pl.index.to(parts.device), parts)
    return x


def leaf_placement(path: str, shape: Sequence[int], tp: int, fsdp: bool, min_size: int,
                   hidden: int) -> Optional[Placement]:
    """The placement of the leaf at flat ``path`` (None: replicated): the
    DiT's TP spec under ``tp > 1``, FSDP's over the data axis composed with
    it under ``fsdp``."""
    shape = tuple(shape)
    base = tp_m.port_spec(path[len("dit."):], torch.empty(shape, device="meta")) \
        if tp > 1 and path.startswith("dit.") else ()
    spec = fsdp_m.fsdp_spec(torch.empty(shape, device="meta"), mesh.data_size(), base,
                            min_size) if fsdp else base
    if not spec:
        return None
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    index = None
    if MODEL_AXIS in spec:
        md = spec.index(MODEL_AXIS)
        index = torch.cat([tp_m.model_index(path, shape[md], tp, r, hidden)
                           for r in range(tp)])
    return Placement(shape, spec, index)


def _leaves(modules: tnn.Module):
    """(path, module, name, tensor, is_param) of every parameter and
    static-int8 buffer."""
    for mpath, mod in modules.named_modules():
        pre = mpath + "." if mpath else ""
        for name, p in mod._parameters.items():
            if p is not None:
                yield pre + name, mod, name, p, True
        for name, b in mod._buffers.items():
            if b is not None and name in _BUFFER_LEAVES:
                yield pre + name, mod, name, b, False


@torch.no_grad()
def place(modules: tnn.Module, tp: int = 1, fsdp: bool = False,
          min_size: int = fsdp_m.MIN_SHARD_SIZE, hidden: Optional[int] = None
          ) -> Dict[str, Placement]:
    """Shard ``modules`` in place (see the module docstring); returns the
    layout of the sharded leaves.  Every rank calls it alike."""
    layout = {}
    for path, mod, name, t, is_param in list(_leaves(modules)):
        pl = leaf_placement(path, t.shape, tp, fsdp, min_size, hidden)
        if pl is None:
            continue
        block = shard(t.detach(), pl)
        if is_param:
            setattr(mod, name, tnn.Parameter(block, requires_grad=t.requires_grad))
        else:
            mod._buffers[name] = block
        if pl.dim(MODEL_AXIS) is not None and name in ("weight", "weight_q"):
            mod.tp_mode = "col" if pl.dim(MODEL_AXIS) == 0 else "row"
        if pl.dim(DATA_AXIS) is not None:
            fsdp_m.shard_leaf(mod, name, pl.dim(DATA_AXIS))
        layout[path] = pl
    if tp > 1 and "dit" in getattr(modules, "_modules", {}):
        modules["dit"].tp = tp
    return layout


def sub_layout(layout: Dict[str, Placement], prefix: str) -> Dict[str, Placement]:
    """The placements under ``prefix`` (a module's path and a dot), keyed
    by the path below it."""
    return {k[len(prefix):]: v for k, v in layout.items() if k.startswith(prefix)}


def full_state_dict(module: tnn.Module, layout: Dict[str, Placement], prefix: str = ""
                    ) -> Dict[str, torch.Tensor]:
    """``module.state_dict()`` with every sharded entry gathered to its
    whole tensor (``layout`` keyed by flat path, ``prefix`` the module's
    path and a dot).  A collective: every rank calls it."""
    sub = sub_layout(layout, prefix)
    return {k: gather(v, sub.get(k)) for k, v in module.state_dict().items()}


def shard_state_dict(sd: Dict[str, torch.Tensor], layout: Dict[str, Placement],
                     prefix: str = "") -> Dict[str, torch.Tensor]:
    """A whole state dict cut to the rank's blocks (``layout`` keyed by
    flat path, ``prefix`` the module's path and a dot)."""
    sub = sub_layout(layout, prefix)
    return {k: shard(v, sub.get(k)) for k, v in sd.items()}
