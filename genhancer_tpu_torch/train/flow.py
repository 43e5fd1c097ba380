"""Rectified-flow objective, inference schedule and Euler sampling.

Port of ``genhancer_tpu/train/flow.py``: the training objective (identical
in every reference trainer)::

    t   ~ sigmoid(scale_factor * N(0,1))        # logit-normal timesteps
    x_0 ~ N(0,1)
    x_t = (1-t) x_1 + t x_0
    loss = MSE(DiT(x_t, cond, t), x_0 - x_1)    # velocity target

the resolution-shifted sigmoid schedule with the plain (no-CFG) Euler
denoiser the reconstruction path runs, and the two samplers of the
generative core: ``denoise_euler_cfg`` (classifier-free guidance) and
``denoise_controlnet`` (ControlNet residuals, with CFG).  Random draws come
from an explicit ``torch.Generator``.

JAX rounds the weakly-typed constants of the samplers (``t_prev - t_curr``,
``true_gs``, ``controlnet_gs``) to the array's dtype; so do these
(``as_dtype_scalar``).
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from ..core.nn import as_dtype_scalar
from ..parallel import mesh


def sample_timesteps(batch: int, scale_factor: float = 1.0,
                     generator: Optional[torch.Generator] = None, device=None) -> torch.Tensor:
    """Logit-normal t in (0, 1): sigmoid(scale * N(0, 1)), float32 [batch]."""
    n = torch.randn((batch,), generator=generator, dtype=torch.float32, device=device)
    return torch.sigmoid(n * scale_factor)


def interpolate(x_1: torch.Tensor, x_0: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """x_t = (1-t) x_1 + t x_0 over [B, L, C] tokens with t [B]."""
    t = t[:, None, None].to(x_1.dtype)
    return (1.0 - t) * x_1 + t * x_0


def velocity_target(x_1: torch.Tensor, x_0: torch.Tensor) -> torch.Tensor:
    return x_0 - x_1


def mse_loss(pred: torch.Tensor, target: torch.Tensor,
             mask: Optional[torch.Tensor] = None, tokens: Optional[int] = None) -> torch.Tensor:
    """Mean-squared error in float32.  ``mask`` [B] gates padded rows.

    Data parallel: the mean is over the global batch (``flow.py:39-48``
    takes it over the whole data axis), so each rank returns its rows' sum
    over the global count of valid elements (the valid rows' count summed
    over the data axis, one collective) and the data ranks' losses and
    gradients add up to the global batch's.  A mean of the ranks' means
    would weigh the rows of a rank with fewer valid rows more.  The model
    and pipe ranks of one data index hold the same rows and count them
    once.  Sequence parallel: ``pred`` and ``target`` hold the rank's share
    of the token axis and ``tokens`` is the whole axis's length, so the
    count is valid rows x ``tokens`` x channels and the seq ranks' losses
    add up too; a rank without tokens returns 0.  One process: the plain
    mean."""
    err = (pred.to(torch.float32) - target.to(torch.float32)).square()
    tokens = err.shape[1] if tokens is None else int(tokens)
    if mask is None:
        if mesh.data_size() == 1 and tokens == err.shape[1]:
            return err.mean()
        return err.sum() / float(err.shape[0] * tokens * err.shape[2] * mesh.data_size())
    m = mask.to(torch.float32)[:, None, None]
    count = m.sum()
    mesh.all_reduce_sum([count])
    denom = torch.clamp(count * tokens * err.shape[2], min=1.0)
    return (err * m).sum() / denom


def time_shift(mu: float, sigma: float, t):
    return math.exp(mu) / (math.exp(mu) + (1.0 / t - 1.0) ** sigma)


def get_schedule(num_steps: int, image_seq_len: int, base_shift: float = 0.5,
                 max_shift: float = 1.15, shift: bool = True):
    """Python list of timesteps, 1 -> 0."""
    import numpy as np
    timesteps = np.linspace(1.0, 0.0, num_steps + 1)
    if shift:
        m = (max_shift - base_shift) / (4096 - 256)
        b = base_shift - m * 256
        mu = m * image_seq_len + b
        with np.errstate(divide="ignore"):
            timesteps = math.exp(mu) / (math.exp(mu) + (1.0 / timesteps - 1.0) ** 1.0)
        timesteps[0] = 1.0
    return [float(t) for t in timesteps]


def denoise_euler(model_fn, img: torch.Tensor, timesteps, guidance: float = 4.0):
    """Euler integration: img += (t_prev - t_curr) * v(img, t).

    ``model_fn(img, t_vec, guidance_vec) -> velocity``.  t_vec and the
    guidance vector are made in img's dtype; the step size is rounded to that
    dtype as JAX rounds the weakly-typed constant."""
    b = img.shape[0]
    guidance_vec = torch.full((b,), guidance, dtype=img.dtype, device=img.device)
    for t_curr, t_prev in zip(timesteps[:-1], timesteps[1:]):
        t_vec = torch.full((b,), t_curr, dtype=img.dtype, device=img.device)
        pred = model_fn(img, t_vec, guidance_vec)
        img = img + as_dtype_scalar(t_prev - t_curr, img.dtype) * pred
    return img


def denoise_euler_cfg(model_fn, img: torch.Tensor, timesteps, *, guidance: float = 4.0,
                      true_gs: float = 1.0, neg_model_fn=None,
                      timestep_to_start_cfg: int = 0):
    """Euler sampler with classifier-free guidance (``flow.py:75-95``):
    ``pred = neg + true_gs * (pos - neg)`` from step
    ``timestep_to_start_cfg`` on, ``neg`` from ``neg_model_fn``; without it
    this is ``denoise_euler``."""
    b = img.shape[0]
    guidance_vec = torch.full((b,), guidance, dtype=img.dtype, device=img.device)
    gs = as_dtype_scalar(true_gs, img.dtype)
    for i, (t_curr, t_prev) in enumerate(zip(timesteps[:-1], timesteps[1:])):
        t_vec = torch.full((b,), t_curr, dtype=img.dtype, device=img.device)
        pred = model_fn(img, t_vec, guidance_vec)
        if neg_model_fn is not None and i >= timestep_to_start_cfg:
            neg_pred = neg_model_fn(img, t_vec, guidance_vec)
            pred = neg_pred + gs * (pred - neg_pred)
        img = img + as_dtype_scalar(t_prev - t_curr, img.dtype) * pred
    return img


def denoise_controlnet(model_fn, controlnet_fn, img: torch.Tensor, timesteps, *,
                       guidance: float = 4.0, true_gs: float = 1.0,
                       controlnet_gs: float = 0.7, neg_model_fn=None,
                       neg_controlnet_fn=None, timestep_to_start_cfg: int = 0):
    """ControlNet-guided Euler sampler (``flow.py:98-134``).

    ``controlnet_fn(img, t_vec, g_vec)`` gives the residuals, each scaled by
    ``controlnet_gs`` and handed to ``model_fn(img, t_vec, g_vec,
    residuals)``.  Under CFG the negative branch runs its own ControlNet
    pass under the negative conditioning, as the reference does, so
    ``neg_controlnet_fn`` is required with ``neg_model_fn`` (pass
    ``controlnet_fn`` to reuse the positive conditioning knowingly)."""
    if neg_model_fn is not None and neg_controlnet_fn is None:
        raise ValueError(
            "neg_model_fn given without neg_controlnet_fn: the reference runs the "
            "controlnet under the NEGATIVE text conditioning in the CFG branch "
            "(sampling.py:205-213).  Pass neg_controlnet_fn (or "
            "neg_controlnet_fn=controlnet_fn to knowingly reuse the positive conditioning)")
    b = img.shape[0]
    guidance_vec = torch.full((b,), guidance, dtype=img.dtype, device=img.device)
    gs = as_dtype_scalar(true_gs, img.dtype)

    def scaled(residuals):
        return tuple(as_dtype_scalar(controlnet_gs, r.dtype) * r for r in residuals)

    for i, (t_curr, t_prev) in enumerate(zip(timesteps[:-1], timesteps[1:])):
        t_vec = torch.full((b,), t_curr, dtype=img.dtype, device=img.device)
        pred = model_fn(img, t_vec, guidance_vec, scaled(controlnet_fn(img, t_vec, guidance_vec)))
        if neg_model_fn is not None and i >= timestep_to_start_cfg:
            neg_res = scaled(neg_controlnet_fn(img, t_vec, guidance_vec))
            neg_pred = neg_model_fn(img, t_vec, guidance_vec, neg_res)
            pred = neg_pred + gs * (pred - neg_pred)
        img = img + as_dtype_scalar(t_prev - t_curr, img.dtype) * pred
    return img
