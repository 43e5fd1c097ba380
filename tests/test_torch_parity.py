"""Shared helpers of the JAX -> PyTorch parity tests (tests/test_torch_*.py).

Tiny configurations (the TINY_* of tests/test_serve.py), their PyTorch-port
counterparts, JAX-initialised parameters and the port modules loaded with
them through ``genhancer_tpu_torch.weights.convert``.  Inputs are made with
numpy from a seed and handed to both packages.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from genhancer_tpu.models import dit as jdit
from genhancer_tpu.models import vae as jvae
from genhancer_tpu.models.towers import clip as jclip
from genhancer_tpu.models.towers import siglip as jsiglip
from genhancer_tpu.tasks import image as jimage
from genhancer_tpu_torch.models import dit as tdit
from genhancer_tpu_torch.models import vae as tvae
from genhancer_tpu_torch.models.towers import clip as tclip
from genhancer_tpu_torch.models.towers import siglip as tsiglip
from genhancer_tpu_torch.tasks import image as timage
from genhancer_tpu_torch.weights.convert import load_jax_params

torch.set_num_threads(1)

TINY_DIT = jdit.DiTConfig(in_channels=16, vec_in_dim=24, context_in_dim=32,
                          hidden_size=64, num_heads=4, depth=1,
                          depth_single_blocks=1, axes_dim=(4, 6, 6))
TINY_VAE = jvae.VAEConfig(resolution=32, ch=8, ch_mult=(1, 2), num_res_blocks=1,
                          z_channels=4)
TINY_TOWER = jclip.CLIPConfig(
    vision=jclip.CLIPVisionConfig(hidden_size=16, intermediate_size=32,
                                  num_layers=1, num_heads=2, image_size=32,
                                  patch_size=16),
    text=jclip.CLIPTextConfig(hidden_size=16, intermediate_size=32,
                              num_layers=1, num_heads=2, vocab_size=50,
                              max_position_embeddings=8),
    projection_dim=24)

TORCH_DTYPE = {jnp.dtype(jnp.float32): torch.float32,
               jnp.dtype(jnp.bfloat16): torch.bfloat16}


def torch_dtype(jdt) -> torch.dtype:
    return TORCH_DTYPE[jnp.dtype(jdt)]


def port_cfg(cfg):
    """A JAX config dataclass -> the port's dataclass with equal fields."""
    if isinstance(cfg, jdit.DiTConfig):
        return tdit.DiTConfig(**dataclasses.asdict(cfg))
    if isinstance(cfg, jvae.VAEConfig):
        return tvae.VAEConfig(**dataclasses.asdict(cfg))
    if isinstance(cfg, jclip.CLIPConfig):
        return tclip.CLIPConfig(
            vision=tclip.CLIPVisionConfig(**dataclasses.asdict(cfg.vision)),
            text=tclip.CLIPTextConfig(**dataclasses.asdict(cfg.text)),
            projection_dim=cfg.projection_dim, logit_scale_init=cfg.logit_scale_init)
    if isinstance(cfg, jsiglip.SiglipConfig):
        return tsiglip.SiglipConfig(
            vision=tsiglip.SiglipVisionConfig(**dataclasses.asdict(cfg.vision)),
            text=tsiglip.SiglipTextConfig(**dataclasses.asdict(cfg.text)))
    raise TypeError(type(cfg))


def jax_spec(compute_dtype=jnp.float32, dit_param_dtype=jnp.bfloat16):
    return jimage.TaskSpec(
        stage="stage1", tower_kind="clip", img_size=32, clip_image_size=32,
        dit_cfg=TINY_DIT, vae_cfg=TINY_VAE, tower_cfg=TINY_TOWER,
        clip_dim=24, t5_dim=32, compute_dtype=compute_dtype,
        dit_param_dtype=dit_param_dtype)


def port_spec(spec) -> timage.TaskSpec:
    return timage.TaskSpec(
        stage=spec.stage, tower_kind=spec.tower_kind, img_size=spec.img_size,
        clip_image_size=spec.clip_image_size, dit_cfg=port_cfg(spec.dit_cfg),
        vae_cfg=port_cfg(spec.vae_cfg), tower_cfg=port_cfg(spec.tower_cfg),
        clip_dim=spec.clip_dim, t5_dim=spec.t5_dim,
        scale_factor=spec.scale_factor, guidance=spec.guidance,
        compute_dtype=torch_dtype(spec.compute_dtype),
        dit_param_dtype=torch_dtype(spec.dit_param_dtype))


def jax_params(spec, seed: int = 0) -> dict:
    """The serving tree {dit, vae, clip} of a JAX init, as numpy leaves."""
    m = jimage.init_modules(jax.random.key(seed), spec)
    return jax.device_get({"dit": m["dit"], "vae": m["vae"], "clip": m["clip"]})


def port_modules(spec, params):
    """Port modules for ``spec`` (a JAX spec) holding the JAX ``params``."""
    mods = timage.build_modules(port_spec(spec))
    load_jax_params(mods, params)
    return mods.eval().requires_grad_(False)


def t(x) -> torch.Tensor:
    """numpy -> torch (bf16-aware)."""
    x = np.asarray(x)
    if x.dtype.name == "bfloat16":
        return torch.from_numpy(x.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(x, copy=True))


def f32(x) -> np.ndarray:
    """torch or jax array -> float32 numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def test_port_spec_mirrors_jax_spec():
    spec = jax_spec()
    ps = port_spec(spec)
    for f in ("dit_cfg", "vae_cfg", "tower_cfg"):
        assert dataclasses.asdict(getattr(ps, f)) == dataclasses.asdict(getattr(spec, f))
    assert ps.latent_hw == spec.latent_hw and ps.tower_hidden == spec.tower_hidden
    assert ps.dit_param_dtype == torch.bfloat16 and ps.compute_dtype == torch.float32
