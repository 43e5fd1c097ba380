"""Train state: flat-path trainable/frozen split + optimizer state.

Port of ``genhancer_tpu/train/state.py``.  The modules stay one
``nn.ModuleDict`` in the reference layout; ``partition`` splits its
parameters by flat path (``dit.img_in.weight``,
``clip.project_clip.1.weight`` ...) into ``trainable`` (``requires_grad``
True: autograd computes their gradients) and ``frozen`` (``requires_grad``
False: no backward through the VAE and the tower).  The optimizer state is
plain tensors that the optimizer owns, covering exactly the trainable
leaves.

``quant`` is the optimizer-maintained int8 copy of the DiT's SwitchBack
weights, ``{path: (wq int8 [o, i], ws float32 [o])}`` (``state.py:53-57``),
or None.  The tensors are the non-persistent buffers ``weight_sb_q`` and
``weight_sb_scale`` of the ``Linear`` that owns the weight, so the forward
reads them (``core.nn.linear``) without their becoming parameters or
state-dict keys; K4/K6 overwrite them in place, and anything else rebuilds
them from the masters.  Derived state: never checkpointed.

Tensor parallelism and FSDP (``place_state``, after the modules are built
and loaded whole): ``layout`` maps the path of each leaf that is the rank's
block to its ``parallel.layout.Placement``, ``partial`` names the
replicated leaves whose gradients are partial sums over the model axis
(the QK-norm scales), and the optimizer state covers the blocks.

``whole`` names the leaves whose gradient every rank computes whole, for
the global batch (the SwitchBack weights of ``dit_quant: int8_dw`` and
``int8_full``: K8 and the per-column int8 dW run on the rows of every
rank, ``core.quant``): they take no data or seq sum.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, Optional, Tuple

import torch
from torch import nn as tnn

from .. import tracing
from ..parallel import mesh


def flatten_params(modules: tnn.Module) -> Dict[str, tnn.Parameter]:
    """``{flat path: parameter}`` under the module tree's names."""
    return dict(modules.named_parameters())


@dataclass
class TrainState:
    modules: tnn.ModuleDict
    trainable: Dict[str, tnn.Parameter]
    frozen: Dict[str, tnn.Parameter]
    opt_state: dict
    step: int = 0
    quant: Optional[dict] = None
    layout: dict = field(default_factory=dict)
    partial: Tuple[str, ...] = ()
    whole: Tuple[str, ...] = ()


def partition(modules: tnn.Module, trainable_pred: Callable[[str], bool]):
    """-> (trainable, frozen) flat dicts; sets ``requires_grad`` to match.
    ``trainable_pred`` receives the full flat path."""
    flat = flatten_params(modules)
    trainable = {k: v for k, v in flat.items() if trainable_pred(k)}
    frozen = {k: v for k, v in flat.items() if k not in trainable}
    for v in trainable.values():
        v.requires_grad_(True)
    for v in frozen.values():
        v.requires_grad_(False)
    return trainable, frozen


def create_state(modules: tnn.Module, trainable_pred, optimizer) -> TrainState:
    trainable, frozen = partition(modules, trainable_pred)
    if not trainable:
        raise ValueError("no trainable parameters matched")
    return TrainState(modules=modules, trainable=trainable, frozen=frozen,
                      opt_state=optimizer.init({k: v.detach() for k, v in trainable.items()}))


def place_state(state: TrainState, optimizer, tp: int = 1, fsdp: bool = False,
                min_size: Optional[int] = None, hidden: Optional[int] = None) -> TrainState:
    """Shard the state's modules over the mesh (``parallel.layout.place``:
    the DiT's TP layout with ``tp > 1``, FSDP's over the data axis with
    ``fsdp``), in place, and start the optimizer state on the blocks.  Every
    rank calls it alike, after ``mesh.make_mesh``; a one-axis-free call
    (``tp`` 1, no ``fsdp``) leaves the state as it is."""
    from ..parallel import fsdp as fsdp_m
    from ..parallel import layout as layout_m
    from ..parallel import tp as tp_m
    if tp <= 1 and not fsdp:
        return state
    state.layout = layout_m.place(state.modules, tp, fsdp,
                                  fsdp_m.MIN_SHARD_SIZE if min_size is None else min_size,
                                  hidden)
    flat = flatten_params(state.modules)
    state.trainable = {k: flat[k] for k in state.trainable}
    state.frozen = {k: flat[k] for k in state.frozen}
    state.partial = tuple(k for k in state.trainable if tp > 1 and k.startswith("dit.")
                          and tp_m.partial_over_model(k[len("dit."):]))
    state.opt_state = optimizer.init({k: v.detach() for k, v in state.trainable.items()},
                                     layout={k: v for k, v in state.layout.items()
                                             if k in state.trainable})
    for k in state.whole:           # an FSDP block of a whole gradient: sliced, not summed
        pl = state.layout.get(k)
        if pl is not None and pl.dim(mesh.DATA_AXIS) is not None:
            parent, _, name = k.rpartition(".")
            fsdp_m.whole_grad(state.modules.get_submodule(parent), name)
    return state


def mark_whole_grads(state: TrainState, dit_quant: str) -> TrainState:
    """Name the state's ``whole`` leaves for ``dit_quant`` (before
    ``place_state``, which reads them)."""
    from ..core.quant import global_dw_paths
    state.whole = global_dw_paths(state.trainable, dit_quant, state.layout)
    return state


def apply_gradients(state: TrainState, grads: Dict[str, torch.Tensor], optimizer,
                    loss: Optional[torch.Tensor] = None):
    """One optimizer step, parameters updated in place; returns the global
    gradient norm and ``loss`` (device scalars).  An optimizer that emits
    the int8 cache (``emit_quant``) writes it in the update; otherwise the
    cache, if any, is rebuilt from the new masters (``state.py:95-112``).

    Data parallel (an initialised ``torch.distributed`` group): the
    gradients, and the loss with them, are first summed over the ranks in
    flat buckets (``parallel.mesh.all_reduce_sum``): each rank's loss and
    gradients are its rows' share of the global batch's, so every rank then
    holds the global batch's and runs the same update.  ZeRO-1: the
    optimizer updates the rows its state's ``rows`` names, and those rows
    of every rank are then gathered into each parameter, and into the int8
    cache's codes and scales where the update wrote them.

    On the 2-D mesh the sum runs over the data axis; an FSDP block's
    gradient arrives reduce-scattered over it already (``parallel.fsdp``)
    and is left out, and the ``partial`` leaves are then summed over the
    model axis.  Sequence parallel: every rank's loss and gradients are
    its tokens' share, so all of them (and the loss) are also summed over
    the seq axis.  Pipeline parallel: a block's gradient lives on its stage
    (``parallel.pp``), so the blocks are also summed over the pipe axis; the
    prologue's, the final layer's and the loss are whole on every pipe rank
    and count once.  The ``whole`` leaves (the global batch's gradient on
    every rank already) take no data or seq sum.  The norm is then taken on
    the reduced gradients, each leaf whole and once."""
    if mesh.is_distributed():
        with tracing.span(tracing.OPTIM_REDUCE):
            reduce_gradients(state, grads, loss)
    params = {k: v.detach() for k, v in state.trainable.items()}
    emits = state.quant is not None and getattr(optimizer, "emit_quant", False)
    with tracing.span(tracing.OPTIM_APPLY):
        state.opt_state, g_norm = optimizer.apply(params, grads, state.opt_state,
                                                  **({"quant": state.quant} if emits else {}))
    rows = state.opt_state.get("rows")
    if rows:
        leaves = [(t, r) for k, r in rows.items()
                  for t in (params[k], *(state.quant.get(k, ()) if emits else ()))]
        with tracing.span(tracing.OPTIM_GATHER):
            mesh.all_gather_rows([t[r0:r1] for t, (r0, r1) in leaves],
                                 [t for t, _ in leaves])
    state.step += 1
    if state.quant is not None and not emits:
        with_quant_cache(state)
    return g_norm, loss


def reduce_gradients(state: TrainState, grads: Dict[str, torch.Tensor],
                     loss: Optional[torch.Tensor] = None) -> None:
    """The sums of ``apply_gradients`` over the mesh's axes, in place: the
    data axis (not the FSDP blocks), the model axis (the ``partial``
    leaves), the seq axis (everything) and the pipe axis (the blocks); the
    ``whole`` leaves on neither the data nor the seq axis."""
    from ..parallel.mesh import DATA_AXIS, MODEL_AXIS, PIPE_AXIS, SEQ_AXIS
    from ..parallel.pp import pipe_owned
    extra = [loss] if loss is not None else []
    whole = set(state.whole)
    data = [g for k, g in grads.items() if k not in whole and (
        k not in state.layout or state.layout[k].dim(DATA_AXIS) is None)]
    mesh.all_reduce_sum(data + extra)
    mesh.all_reduce_sum([grads[k] for k in state.partial], group=MODEL_AXIS)
    mesh.all_reduce_sum([g for k, g in grads.items() if k not in whole] + extra,
                        group=SEQ_AXIS)
    mesh.all_reduce_sum([g for k, g in grads.items() if pipe_owned(k)], group=PIPE_AXIS)


def with_quant_cache(state: TrainState) -> TrainState:
    """Fill the int8 SwitchBack weight cache from the current masters, on
    create and on resume (``with_quant_cache:115``): ``quantize_weight`` of
    every path of ``switchback_cache_paths``, set as the owning ``Linear``'s
    non-persistent buffers."""
    from ..core.quant import quantize_cache, switchback_cache_paths
    paths = switchback_cache_paths(state.trainable, state.layout)
    if not paths:
        return state
    state.quant = {}
    for path, (wq, ws) in quantize_cache(state.trainable, paths, state.layout).items():
        mod = state.modules.get_submodule(path[: -len(".weight")])
        mod.register_buffer("weight_sb_q", wq, persistent=False)
        mod.register_buffer("weight_sb_scale", ws, persistent=False)
        state.quant[path] = (mod.weight_sb_q, mod.weight_sb_scale)
    return state
