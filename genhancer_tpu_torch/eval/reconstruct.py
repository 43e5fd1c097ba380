"""Stage-1 reconstruction: the visual smoke test.

Port of ``genhancer_tpu/eval/reconstruct.py:25-123``: given an input image
and stage-1 checkpoints, condition the DiT on the tower's class token, run
the shifted-schedule Euler sampler from pure noise, decode with the VAE and
save input/output JPEGs.  The sampler is ``train.flow``'s, the DiT
``dit_forward`` (K1 at joint L=197 on CUDA), the conditioning
``image_conditioning`` (K2).  The NHWC noise is drawn from ``seed`` on the
modules' device or injected (``noise``), as a test hands in JAX's draw.
With ``controlnet_params`` (a ``models.controlnet.ControlNet``) the sampler
is ``flow.denoise_controlnet``: the control image (by default the input)
is VAE-encoded to its posterior mean, packed, and drives the ControlNet's
residuals, scaled by ``controlnet_gs``.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from ..models import dit as dit_m
from ..models import vae as vae_m
from ..tasks.conditioning import image_conditioning
from ..train import flow


@torch.no_grad()
def reconstruct(modules, spec, image01: np.ndarray, *, num_steps: int = 20,
                guidance: float = 4.0, seed: int = 0, shift_schedule: bool = True,
                controlnet_params=None, control_image01: Optional[np.ndarray] = None,
                controlnet_gs: float = 0.7,
                noise: Optional[np.ndarray] = None) -> np.ndarray:
    """modules: the image ``init_modules`` tree {dit, vae, clip{model,
    project_clip, project_t5}}; spec: ``tasks.image.TaskSpec``; image01:
    [B, H, W, 3] in [0, 1].  Returns the reconstruction [B, H, W, 3] in
    [0, 1]; ``noise``: [B, lat_h, lat_w, z] float32, else drawn from
    ``seed``.  ``controlnet_params``: a ControlNet on the modules' device,
    conditioned on ``control_image01`` ([B, H, W, 3] in [0, 1], default
    ``image01``) with residual scale ``controlnet_gs``
    (``reconstruct.py:25-92``)."""
    dev = next(modules["dit"].parameters()).device
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    b = image01.shape[0]
    lat_h, lat_w = spec.latent_hw
    timesteps = flow.get_schedule(num_steps, (lat_h // 2) * (lat_w // 2),
                                  shift=shift_schedule)
    if noise is None:
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(seed))
        noise = torch.randn((b, lat_h, lat_w, spec.vae_cfg.z_channels), generator=gen,
                            dtype=torch.float32, device=dev)
    else:
        noise = torch.as_tensor(noise, dtype=torch.float32).to(dev)
    image01 = torch.as_tensor(image01, dtype=torch.float32).to(dev)
    cond = image_conditioning(spec.tower_kind, modules["clip"], image01, spec.tower_cfg,
                              spec.latent_hw, compute_dtype=spec.compute_dtype)
    img = dit_m.pack_latent(noise).to(spec.compute_dtype)

    def model_fn(x, t_vec, g_vec, res=None):
        return dit_m.dit_forward(
            modules["dit"], spec.dit_cfg, img=x, img_ids=cond["img_ids"],
            txt=cond["txt"].to(x.dtype), txt_ids=cond["txt_ids"], timesteps=t_vec,
            y=cond["vec"].to(x.dtype), guidance=g_vec, controlnet_residuals=res)

    if controlnet_params is None:
        tokens = flow.denoise_euler(model_fn, img, timesteps, guidance)
    else:
        tokens = _denoise_controlnet(modules, spec, cond, model_fn, img, timesteps, guidance,
                                     controlnet_params,
                                     image01 if control_image01 is None else control_image01,
                                     controlnet_gs)
    lat = dit_m.unpack_latent(tokens.to(torch.float32), lat_h, lat_w)
    out = vae_m.vae_decode(modules["vae"], spec.vae_cfg, lat)
    return torch.clamp(out * 0.5 + 0.5, 0.0, 1.0).cpu().numpy()   # inverse 0.5/0.5


def _denoise_controlnet(modules, spec, cond, model_fn, img, timesteps, guidance,
                        controlnet, control_image01, controlnet_gs):
    """The ControlNet sampler of ``reconstruct``: the control image's
    deterministic (mean) latent of ``x * 2 - 1``, packed, conditions every
    ControlNet pass."""
    from ..models import controlnet as cn_m
    ctl01 = torch.as_tensor(control_image01, dtype=torch.float32).to(img.device)
    ctl = vae_m.vae_encode(modules["vae"], spec.vae_cfg, ctl01 * 2.0 - 1.0, sample=False)
    ctl_tokens = dit_m.pack_latent(ctl).to(spec.compute_dtype)

    def cn_fn(x, t_vec, g_vec):
        return cn_m.controlnet_forward(
            controlnet, spec.dit_cfg, img=x, img_ids=cond["img_ids"],
            txt=cond["txt"].to(x.dtype), txt_ids=cond["txt_ids"], timesteps=t_vec,
            y=cond["vec"].to(x.dtype), guidance=g_vec, controlnet_cond=ctl_tokens)

    return flow.denoise_controlnet(model_fn, cn_fn, img, timesteps, guidance=guidance,
                                   controlnet_gs=controlnet_gs)


def reconstruct_from_checkpoints(spec, load_dir: str, load_step: int, image_path: str,
                                 output_dir: str, num_steps: int = 20, seed: int = 0,
                                 device="cuda") -> str:
    """Build the image modules on ``device`` (random init from ``seed``, the
    tower from ``spec.tower_dir``), load the stage-1 ``.bin`` files of
    ``load_step``, reconstruct one image and save ``input.jpg`` and
    ``reconstruction.jpg`` in ``output_dir``; returns the latter's path."""
    from PIL import Image

    from ..data.transforms import eval_image_transform
    from ..serve.engine import resolve_device
    from ..tasks.image import init_modules
    from ..train.checkpoint import load_stage1_components

    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    modules = init_modules(spec, gen, device=dev)
    load_stage1_components(modules, load_dir, load_step, kind="image")
    with open(image_path, "rb") as f:
        img = eval_image_transform(f.read(), spec.img_size)
    out = reconstruct(modules, spec, img[None], num_steps=num_steps, seed=seed)

    os.makedirs(output_dir, exist_ok=True)
    in_path = os.path.join(output_dir, "input.jpg")
    out_path = os.path.join(output_dir, "reconstruction.jpg")
    Image.fromarray((img * 255).astype(np.uint8)).save(in_path)
    Image.fromarray((out[0] * 255).astype(np.uint8)).save(out_path)
    return out_path
