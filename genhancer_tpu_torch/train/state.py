"""Train state: flat-path trainable/frozen split + optimizer state.

Port of ``genhancer_tpu/train/state.py``.  The modules stay one
``nn.ModuleDict`` in the reference layout; ``partition`` splits its
parameters by flat path (``dit.img_in.weight``,
``clip.project_clip.1.weight`` ...) into ``trainable`` (``requires_grad``
True: autograd computes their gradients) and ``frozen`` (``requires_grad``
False: no backward through the VAE and the tower).  The optimizer state is
plain tensors that the optimizer owns, covering exactly the trainable
leaves.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict

import torch
from torch import nn as tnn


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


def apply_gradients(state: TrainState, grads: Dict[str, torch.Tensor], optimizer):
    """One optimizer step, parameters updated in place; returns the global
    gradient norm (a device scalar)."""
    params = {k: v.detach() for k, v in state.trainable.items()}
    state.opt_state, g_norm = optimizer.apply(params, grads, state.opt_state)
    state.step += 1
    return g_norm
