"""Optimizer: global-norm clipping + AdamW + learning-rate schedules.

Port of ``genhancer_tpu/train/optim.py``.  Two implementations, selected by
the config's ``fused_optimizer`` as in JAX:

* the default chain, ``optax.chain(clip_by_global_norm(c), adamw(...))``
  (optax 0.2.6), as plain torch, one function per optax stage:
  ``clip_by_global_norm`` -> ``scale_by_adam`` -> ``add_decayed_weights`` ->
  ``scale_by_learning_rate`` -> ``apply_updates``.  JAX's dtype rules are
  kept: moments start in the parameter dtype and are promoted by the
  gradients (float32 accumulated grads make them float32 from the first
  step on), and Python constants are rounded to the array's dtype first
  (``core.nn.as_dtype_scalar``), as JAX rounds weakly-typed scalars;
* ``fused_optimizer: pallas`` — the fused clip + AdamW kernel K3
  (``core/kernels/adamw.py``), moments kept in the parameter dtype; with
  ``emit_quant`` it writes the int8 copy of the DiT's SwitchBack weights in
  the same pass (K4), and with ``optimizer_moment_bits: 8`` it keeps
  log-coded int8 moments on the leaves ``moment8_ok`` admits (K6).

Parameters, gradients and moments are flat ``{path: tensor}`` dicts; the
optimizer owns its state as plain tensors (no ``torch.optim``).  ``apply``
updates the parameters in place and returns the new state and the global
gradient norm.  The schedule is a host function of the step count, so no
step needs a host sync.

ZeRO-1 (``shard_optimizer_state``, JAX ``shard_over_data``): ``init``
records in the state's ``rows`` the row range ``[r0, r1)`` that this rank
updates of each leaf whose leading dimension divides the world size
(``parallel.mesh.row_range``) and allocates those rows' moments only; the
other leaves keep whole moments.  ``apply`` takes the global norm over the
whole (reduced, replicated) gradients and updates the views ``p[r0:r1]``
from ``g[r0:r1]``: each row's arithmetic is the whole-leaf update's.  The
caller gathers the other ranks' rows (``train.state.apply_gradients``).

Tensor parallelism and FSDP (``parallel.layout``): ``init`` takes the
layout of the leaves that are the rank's block; their moments are the
block's (``shard_over_data`` skips them), the global norm counts each leaf
whole and once, and the update is the block's (``fused_adamw_apply``
updates a row-parallel leaf of K4 or K6 on its gathered rows).  The state
keeps the layout under ``layout``.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ..core.kernels.adamw import (fused_adamw_apply, global_norm, moment8_ok, moment8_zeros_m,
                                  moment8_zeros_v)
from ..core.nn import as_dtype_scalar
from ..parallel import mesh

Tensors = Dict[str, torch.Tensor]
Schedule = Callable[[int], float]
_F32 = np.float32


def _linear(init: float, end: float, steps: int) -> Schedule:
    """optax.linear_schedule in float32."""
    if steps <= 0:
        return lambda count: init

    def schedule(count):
        c = _F32(min(max(count, 0), steps))
        frac = _F32(1) - c / _F32(steps)
        return float(_F32(init - end) * frac + _F32(end))
    return schedule


def _cosine(init: float, decay_steps: int, alpha: float = 0.0) -> Schedule:
    """optax.cosine_decay_schedule (exponent 1) in float32."""
    def schedule(count):
        c = _F32(min(count, decay_steps))
        decay = _F32(0.5) * (_F32(1) + np.cos(_F32(np.pi) * c / _F32(decay_steps)))
        return float(_F32(init) * (_F32(1 - alpha) * decay + _F32(alpha)))
    return schedule


def _join(first: Schedule, second: Schedule, boundary: int) -> Schedule:
    """optax.join_schedules of two pieces."""
    return lambda count: first(count) if count < boundary else second(count - boundary)


def make_lr_schedule(name: str, learning_rate: float, warmup_steps: int = 0,
                     total_steps: Optional[int] = None) -> Schedule:
    """count -> learning rate, the optax schedules of the JAX package:
    ``constant`` ignores the warmup (diffusers' 'constant'),
    ``constant_with_warmup`` ramps linearly, ``linear`` warms up then decays
    to 0 at ``total_steps``, ``cosine`` is warmup_cosine_decay_schedule."""
    warmup_steps = int(warmup_steps or 0)
    if name in ("constant", "constant_with_warmup"):
        if warmup_steps > 0 and name == "constant_with_warmup":
            return _join(_linear(0.0, learning_rate, warmup_steps),
                         lambda count: learning_rate, warmup_steps)
        return lambda count: learning_rate
    if name == "linear":
        if total_steps is None:
            raise ValueError("lr_scheduler linear needs total_steps")
        return _join(_linear(0.0, learning_rate, warmup_steps),
                     _linear(learning_rate, 0.0, max(total_steps - warmup_steps, 1)),
                     warmup_steps)
    if name == "cosine":
        if total_steps is None:
            raise ValueError("lr_scheduler cosine needs total_steps")
        return _join(_linear(0.0, learning_rate, warmup_steps),
                     _cosine(learning_rate, total_steps - warmup_steps), warmup_steps)
    raise ValueError(f"unknown lr_scheduler: {name}")


# ---------------------------------------------------------------------------
# the default chain, one function per optax stage (one leaf at a time)
# ---------------------------------------------------------------------------

def clip_by_global_norm(g: torch.Tensor, g_norm: torch.Tensor, max_norm: float):
    """optax.clip_by_global_norm: g unchanged while ||g|| < c, else
    ``(g / ||g||) * c`` in g's dtype (no +1e-6)."""
    keep = g_norm < as_dtype_scalar(max_norm, g_norm.dtype)
    clipped = (g / g_norm.to(g.dtype)) * as_dtype_scalar(max_norm, g.dtype)
    return torch.where(keep, g, clipped)


def scale_by_adam(g, mu, nu, count_inc: int, b1: float, b2: float, eps: float):
    """optax.scale_by_adam (eps_root 0): returns (update, mu, nu).  The new
    moments take the promoted dtype of the grad and the old moment."""
    def bias_correction(moment, decay):
        bc = _F32(1) - _F32(decay) ** _F32(count_inc)
        return moment / as_dtype_scalar(float(bc), moment.dtype)

    mu = as_dtype_scalar(1 - b1, g.dtype) * g + as_dtype_scalar(b1, mu.dtype) * mu
    nu = as_dtype_scalar(1 - b2, g.dtype) * (g * g) + as_dtype_scalar(b2, nu.dtype) * nu
    mu_hat, nu_hat = bias_correction(mu, b1), bias_correction(nu, b2)
    update = mu_hat / (torch.sqrt(nu_hat) + as_dtype_scalar(eps, nu_hat.dtype))
    return update, mu, nu


def add_decayed_weights(update, p, weight_decay: float):
    """optax.add_decayed_weights: ``u + wd * p`` (wd * p in p's dtype)."""
    return update + as_dtype_scalar(weight_decay, p.dtype) * p


def scale_by_learning_rate(update, lr: float):
    """optax.scale_by_learning_rate: ``-lr`` rounded to the update's dtype."""
    return as_dtype_scalar(-lr, update.dtype) * update


def apply_updates(p, update):
    """optax.apply_updates: ``(p + u).astype(p.dtype)``."""
    return (p + update).to(p.dtype)


def shard_rows(params: Tensors, shard: bool, layout: Optional[dict] = None
               ) -> Dict[str, Tuple[int, int]]:
    """``{path: (r0, r1)}``: the rows of each leaf this rank's ZeRO-1
    moments cover (``shard``), the leaves it does not split, and those
    already sharded by TP or FSDP (``layout``), left out."""
    if not shard:
        return {}
    layout = layout or {}
    return {k: r for k, p in params.items()
            if k not in layout and (r := mesh.row_range(p.shape)) is not None}


def local_view(x: torch.Tensor, rows: Dict[str, Tuple[int, int]], key: str) -> torch.Tensor:
    """``x[r0:r1]`` for a leaf the rank updates by rows, else ``x``."""
    if key not in rows:
        return x
    r0, r1 = rows[key]
    return x[r0:r1]


def zero_moments(params: Tensors, shard: bool = False, layout: Optional[dict] = None) -> dict:
    """The state both optimizers start from: step count 0, moments of zeros
    in each parameter's dtype (``optax``'s and ``pallas_adamw_clip``'s init),
    of the rank's rows under ZeRO-1 (``shard``: the state's ``rows``)."""
    rows = shard_rows(params, shard, layout)
    local = {k: local_view(p, rows, k) for k, p in params.items()}
    state = {"count": 0, "mu": {k: torch.zeros_like(p) for k, p in local.items()},
             "nu": {k: torch.zeros_like(p) for k, p in local.items()}}
    return _with(state, rows if shard else None, layout)


def _with(state: dict, rows, layout) -> dict:
    """``state`` with its ZeRO-1 ``rows`` (where given) and the layout of the
    sharded leaves (where any)."""
    if rows is not None:
        state["rows"] = rows
    if layout:
        state["layout"] = dict(layout)
    return state


def _norm_axes(state: dict) -> Dict[str, str]:
    return {k: pl.axes for k, pl in state.get("layout", {}).items()}


class AdamWChain:
    """``clip_by_global_norm`` then ``adamw``, stage by stage, leaf by leaf
    (temporaries for one leaf at a time)."""

    def __init__(self, schedule: Schedule, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8, weight_decay: float = 0.01, max_grad_norm: float = 1.0,
                 shard: bool = False):
        self.schedule = schedule
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay, self.max_grad_norm = weight_decay, max_grad_norm
        self.shard = shard

    def init(self, params: Tensors, layout: Optional[dict] = None) -> dict:
        return zero_moments(params, self.shard, layout)

    @torch.no_grad()
    def apply(self, params: Tensors, grads: Tensors, state: dict) -> Tuple[dict, torch.Tensor]:
        g_norm = global_norm(grads, _norm_axes(state))
        count = state["count"]
        lr = _F32(self.schedule(count))      # read at the pre-increment count
        mu, nu = state["mu"], state["nu"]     # replaced leaf by leaf
        rows = state.get("rows", {})
        for k, p in params.items():
            p = local_view(p, rows, k)
            g = clip_by_global_norm(local_view(grads[k], rows, k), g_norm, self.max_grad_norm)
            u, mu[k], nu[k] = scale_by_adam(g, mu[k], nu[k], count + 1,
                                            self.b1, self.b2, self.eps)
            u = add_decayed_weights(u, p, self.weight_decay)
            u = scale_by_learning_rate(u, float(lr))
            p.copy_(apply_updates(p, u))
        return {**state, "count": count + 1, "mu": mu, "nu": nu}, g_norm


class FusedAdamW:
    """``fused_optimizer: pallas`` (``pallas_adamw_clip:115``): clip + AdamW
    in one kernel pass per leaf, in place; moments in the parameter dtype,
    or, with ``moment_bits=8``, ``Moment8`` codes on the ``moment8_ok``
    leaves.  ``emit_quant``: ``apply`` takes the state's int8 weight cache
    and the update writes it (K4, or K6's quant body)."""

    def __init__(self, schedule: Schedule, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8, weight_decay: float = 0.01, max_grad_norm: float = 1.0,
                 emit_quant: bool = False, moment_bits: int = 16, shard: bool = False):
        self.schedule = schedule
        self.emit_quant, self.moment_bits, self.shard = emit_quant, moment_bits, shard
        self.kw = dict(b1=b1, b2=b2, eps=eps, weight_decay=weight_decay,
                       max_grad_norm=max_grad_norm)

    def init(self, params: Tensors, layout: Optional[dict] = None) -> dict:
        if self.moment_bits != 8:
            return zero_moments(params, self.shard, layout)
        # moment8_ok reads the whole leaf; the codes cover the rank's rows,
        # or its block (TP: a row-parallel block keeps whole rows' scales)
        layout = layout or {}
        rows = shard_rows(params, self.shard, layout)
        local = {k: local_view(p, rows, k) for k, p in params.items()}

        def eight(k, p):
            return moment8_ok(torch.empty(layout[k].shape, device="meta") if k in layout else p)

        state = {"count": 0,
                 "mu": {k: moment8_zeros_m(local[k]) if eight(k, p) else
                        torch.zeros_like(local[k]) for k, p in params.items()},
                 "nu": {k: moment8_zeros_v(local[k]) if eight(k, p) else
                        torch.zeros_like(local[k]) for k, p in params.items()}}
        return _with(state, rows if self.shard else None, layout)

    @torch.no_grad()
    def apply(self, params: Tensors, grads: Tensors, state: dict,
              quant: Optional[dict] = None) -> Tuple[dict, torch.Tensor]:
        count = state["count"] + 1
        g_norm = fused_adamw_apply(params, state["mu"], state["nu"], grads, count,
                                   self.schedule, quant=quant, rows=state.get("rows"),
                                   layout=state.get("layout"), **self.kw)
        return {**state, "count": count}, g_norm


def make_optimizer(cfg, total_steps: Optional[int] = None, fused=None,
                   emit_quant: bool = False, moment_bits: Optional[int] = None):
    """The optimizer of a train config, with the JAX package's knob handling:
    ``fused_optimizer`` "pallas" -> K3 (K4 with ``emit_quant``), True/"xla"
    -> not ported, anything else -> the chain (the default, which ignores
    ``emit_quant``: the state then rebuilds its cache);
    ``optimizer_moment_bits`` 16, or 8 with pallas only (K6);
    ``shard_optimizer_state`` keeps the moments of the rank's rows (ZeRO-1)."""
    schedule = make_lr_schedule(cfg.get("lr_scheduler", "constant"),
                                float(cfg.get("learning_rate", 1e-4)),
                                int(cfg.get("lr_warmup_steps", 0)),
                                total_steps or cfg.get("max_train_steps"))
    kw = dict(b1=float(cfg.get("adam_beta1", 0.9)),
              b2=float(cfg.get("adam_beta2", 0.999)),
              eps=float(cfg.get("adam_epsilon", 1e-8)),
              weight_decay=float(cfg.get("adam_weight_decay", 0.01)),
              max_grad_norm=float(cfg.get("max_grad_norm", 1.0)))
    if fused is None:
        fused = cfg.get("fused_optimizer", False)
    if moment_bits is None:
        moment_bits = int(cfg.get("optimizer_moment_bits", 16))
    if moment_bits not in (8, 16):
        raise ValueError(f"optimizer_moment_bits must be 8 or 16, got {moment_bits}")
    if moment_bits == 8 and fused != "pallas":
        raise ValueError("optimizer_moment_bits: 8 requires fused_optimizer: pallas "
                         "(the 8-bit decode/encode lives in the fused kernel)")
    kw["shard"] = bool(cfg.get("shard_optimizer_state", False))
    if fused == "pallas":
        return FusedAdamW(schedule, emit_quant=emit_quant, moment_bits=moment_bits, **kw)
    if fused in (True, "xla"):
        raise NotImplementedError(
            "fused_optimizer: xla (the single-pass XLA tree_map) is not ported "
            "(ROADMAP: later items); use the default chain or fused_optimizer: pallas")
    return AdamWChain(schedule, **kw)


def effective_steps_per_epoch(train_batch_size: int, grad_accum: int,
                              dataset_size: int = int(3e6)) -> float:
    """Reference hardcodes a 3e6-sample epoch (train_SigLIP_stage1.py:158)."""
    return math.ceil(dataset_size / train_batch_size) / grad_accum
