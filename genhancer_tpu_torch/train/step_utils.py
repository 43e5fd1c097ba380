"""Generic train-step assembly: gradient accumulation, and the host-side
stacking of micro-batches and their extras.

Port of ``genhancer_tpu/train/step_utils.py``.  Micro-batches arrive stacked
on a leading axis (``stack_microbatches``); each runs forward and backward on
its own with the loss scaled by ``1/accum`` (exact for power-of-two accum),
and its gradients, produced by autograd in the parameter dtype, are added
into accumulators of ``accum_dtype`` (float32 by default; ``None`` keeps
each parameter's dtype, ``grad_accum_dtype: param``).  ``.grad`` is cleared
after every micro-batch, so autograd never accumulates in bfloat16.  The
JAX package's unrolled (accum < 5) and ``lax.scan`` lowerings are the same
arithmetic; eager PyTorch runs one Python loop for both.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from .. import tracing
from .state import TrainState, apply_gradients


def make_train_step(loss_fn, optimizer):
    """loss_fn(modules, batch, generator, draws) -> scalar float32.

    Returns ``step(state, batch, generator, draws=None) -> (state,
    metrics)``: one optimizer step on one batch, without accumulation (the
    image and video tasks' step); ``metrics`` as ``make_accum_train_step``'s."""

    def step(state: TrainState, batch, generator=None, draws=None):
        with tracing.span(tracing.STEP, step=state.step):
            loss = loss_fn(state.modules, batch, generator, draws)
            with tracing.span(tracing.BACKWARD):
                loss.backward()
            with torch.no_grad():
                grads = {k: take_grad(p) for k, p in state.trainable.items()}
            g_norm, loss = apply_gradients(state, grads, optimizer, loss.detach())
        return state, {"loss": loss, "grad_norm": g_norm}

    return step


def make_accum_train_step(loss_fn, optimizer, accum_steps: int,
                          accum_dtype: Optional[torch.dtype] = torch.float32):
    """loss_fn(modules, micro_batch, generator, draws) -> scalar float32.

    Returns ``step(state, stacked_batch, generator, draws=None) -> (state,
    metrics)`` where ``stacked_batch`` leaves are ``[accum, B, ...]`` device
    tensors and ``draws`` (tests) is an optional list of per-micro-batch
    injected random draws.  ``metrics``: ``loss`` (the sum of the scaled
    micro losses; under data parallelism summed over the ranks, the global
    batch's loss) and ``grad_norm`` (global norm of the accumulated grads),
    both device scalars."""
    inv = 1.0 / accum_steps

    def step(state: TrainState, stacked_batch, generator=None,
             draws: Optional[Sequence[dict]] = None):
        with tracing.span(tracing.STEP, step=state.step):
            loss_sum, grads = None, None
            for i in range(accum_steps):
                micro = {k: v[i] for k, v in stacked_batch.items()}
                loss = loss_fn(state.modules, micro, generator,
                               draws[i] if draws is not None else None) * inv
                with tracing.span(tracing.BACKWARD):
                    loss.backward()
                with torch.no_grad():
                    micro_grads = {k: take_grad(p) for k, p in state.trainable.items()}
                    if grads is None:   # the first micro-batch's grads are the accumulator
                        grads = {k: g if accum_dtype is None else g.to(accum_dtype)
                                 for k, g in micro_grads.items()}
                    else:
                        for k, g in micro_grads.items():
                            grads[k] += g.to(grads[k].dtype)
                    del micro_grads
                loss_sum = loss.detach() if loss_sum is None else loss_sum + loss.detach()
            g_norm, loss_sum = apply_gradients(state, grads, optimizer, loss_sum)
        return state, {"loss": loss_sum, "grad_norm": g_norm}

    return step


def take_grad(p: torch.Tensor) -> torch.Tensor:
    """p's gradient (zeros where the loss did not reach p), leaving
    ``p.grad`` empty for the next backward."""
    g = p.grad if p.grad is not None else torch.zeros_like(p)
    p.grad = None
    return g


def stack_microbatches(batches):
    """List of host batches (array leaves only) -> stacked pytree.

    Microbatches in one accumulation group can disagree at epoch
    boundaries: a padded partial final batch may be smaller than the others
    and may carry a ``valid`` mask the full batches lack.  Normalize before
    stacking — synthesize all-True masks where missing and pad every leaf
    (mask rows False) up to the group's max batch size — so the mask is
    never silently dropped and ``np.stack`` never sees ragged shapes."""
    import numpy as np
    keys = set().union(*(b.keys() for b in batches))
    sizes = [next(iter(b.values())).shape[0] for b in batches]
    bmax = max(sizes)
    ragged = len(set(sizes)) > 1
    need_valid = ragged or any("valid" in b for b in batches)
    norm = []
    for b, n in zip(batches, sizes):
        bb = dict(b)
        if need_valid and "valid" not in bb:
            bb["valid"] = np.ones((n,), bool)
        missing = keys - set(bb) - {"valid"}
        if missing:
            raise ValueError(f"microbatch missing keys {sorted(missing)}")
        if n < bmax:
            for k, v in bb.items():
                pad = np.zeros((bmax - n,) + v.shape[1:], v.dtype)
                bb[k] = np.concatenate([v, pad], axis=0)
        norm.append(bb)
    return {k: np.stack([b[k] for b in norm]) for k in (keys | ({"valid"} if need_valid else set()))}


def merge_extras(extras_list):
    """A batch's non-array extras (the sliding loader's
    ``avg_windows_per_video``/``bs_eff``) for one accumulation group: numbers
    are averaged over the micro-batches, anything else keeps the last one's
    (``genhancer_tpu/train/trainer.py:287-299``)."""
    import numpy as np
    if len(extras_list) == 1:
        return extras_list[0]
    out = {}
    for k in extras_list[0]:
        vals = [e[k] for e in extras_list if k in e]
        try:
            out[k] = float(np.mean([float(v) for v in vals]))
        except (TypeError, ValueError):
            out[k] = vals[-1]
    return out
