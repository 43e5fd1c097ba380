"""Tower -> DiT conditioning (image and video modes).

Port of ``genhancer_tpu/tasks/conditioning.py``.  Image mode: the tower's
class token (CLIP: the projected pooler output; SigLIP: the MAP-pooled
output) becomes a 1-token txt sequence via ``project_t5`` and
the ``y`` vector via ``project_clip``; img_ids are the (0, row, col) grid
over the packed latent tokens; txt_ids are zeros.  Video modes: the patch
tokens of the 1-3 conditioning frames pass through the VisualPromptAdapter
into the txt space with (t, row, col) ids, t the frame's time; the target's
img_ids carry the target time; ``y`` is the mean of the frames' projected
class tokens.  Raw [0, 1] pixels are normalised exactly once, here, with the
tower's statistics (``tower_stats``).  Nothing here stops gradients: stage 2 runs
``image_conditioning`` under autograd (the LoRA-wrapped tower trains),
stage 1 calls the tower under ``torch.no_grad()`` itself.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch

from .. import tracing
from ..core.rope import spatial_ids
from ..models.towers import clip as clip_m
from ..models.towers import siglip as siglip_m
from ..models.towers.projectors import projector, visual_adapter

OPENAI_CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
OPENAI_CLIP_STD = (0.26862954, 0.26130258, 0.27577711)
SIGLIP_MEAN = (0.5, 0.5, 0.5)
SIGLIP_STD = (0.5, 0.5, 0.5)
VAE_MEAN = (0.5, 0.5, 0.5)
VAE_STD = (0.5, 0.5, 0.5)


def normalize(px: torch.Tensor, mean: Sequence[float], std: Sequence[float]) -> torch.Tensor:
    """px [B, H, W, 3] in [0, 1] -> normalised, in px's dtype."""
    mean = torch.tensor(mean, dtype=px.dtype, device=px.device)
    std = torch.tensor(std, dtype=px.dtype, device=px.device)
    return (px - mean) / std


def tower_stats(kind: str):
    """(mean, std) of the tower's pixel normalisation."""
    return (SIGLIP_MEAN, SIGLIP_STD) if kind == "siglip" else (OPENAI_CLIP_MEAN, OPENAI_CLIP_STD)


def tower_features(kind: str, clip, px: torch.Tensor, cfg):
    """Run the tower's vision side -> (class_token, patch_tokens)
    (``conditioning.py:50-65``).

    ``clip`` holds ``model`` (a CLIPVisionTower or SiglipVisionTower, the
    whole CLIPModel or SiglipModel in stage 2).  CLIP: class_token is
    ``visual_projection(pooler)``, patch_tokens the CLS-stripped hidden
    states before post-LN; SigLIP: class_token is the MAP-pooled output,
    patch_tokens all post-LN tokens (it has no CLS)."""
    tower = clip["model"]
    with tracing.span(tracing.FROZEN_TOWER):
        if kind == "siglip":
            last, pooled = siglip_m.vision_forward(tower.vision_model, px, cfg.vision)
            return pooled, last
        last, pooled = clip_m.vision_forward(tower.vision_model, px, cfg.vision)
        return clip_m.visual_projection(tower, pooled), last[:, 1:]


def image_conditioning(tower_kind: str, clip, pixels01: torch.Tensor, tower_cfg,
                       latent_hw, compute_dtype=torch.bfloat16) -> Dict[str, torch.Tensor]:
    """Image-mode conditioning dict for the DiT.

    pixels01: [B, H, W, 3] in [0, 1]; latent_hw: (h, w) of the latent before
    packing.  Returns txt [B, 1, t5_dim], txt_ids, vec, img_ids."""
    mean, std = tower_stats(tower_kind)
    px = normalize(pixels01, mean, std).to(compute_dtype)
    cls_tok, _ = tower_features(tower_kind, clip, px, tower_cfg)
    return image_conditioning_from_cls(clip, cls_tok, latent_hw,
                                       compute_dtype=compute_dtype)


def image_conditioning_from_cls(clip, cls_tok: torch.Tensor, latent_hw,
                                compute_dtype=torch.bfloat16) -> Dict[str, torch.Tensor]:
    """Projector half of image_conditioning, from a tower class token."""
    cls_tok = cls_tok.to(compute_dtype)
    vec = projector(clip["project_clip"], cls_tok)
    txt = projector(clip["project_t5"], cls_tok[:, None, :])
    b = cls_tok.shape[0]
    h, w = latent_hw
    grid = spatial_ids(h // 2, w // 2, t=0.0, device=cls_tok.device)
    img_ids = grid[None].expand(b, (h // 2) * (w // 2), 3)
    txt_ids = torch.zeros((b, 1, 3), dtype=torch.float32, device=cls_tok.device)
    return {"txt": txt, "txt_ids": txt_ids, "vec": vec, "img_ids": img_ids}


def video_conditioning(modules, cond_frames_patches: Sequence[torch.Tensor],
                       vecs: Sequence[torch.Tensor], latent_hw, patch_grid: int,
                       target_time: float, frame_times: Sequence[float],
                       compute_dtype=torch.bfloat16) -> Dict[str, torch.Tensor]:
    """Video-mode conditioning dict for the DiT (``conditioning.py:97-118``).

    ``modules`` holds ``visual_adapter``; cond_frames_patches: one [B, L_p,
    D_t] patch-token tensor per frame; vecs: one [B, proj_dim] projected
    class token per frame (averaged into ``vec``)."""
    ctx = torch.cat(list(cond_frames_patches), dim=1).to(compute_dtype)
    txt = visual_adapter(modules["visual_adapter"], ctx)
    b, dev = ctx.shape[0], ctx.device
    ids = torch.cat([spatial_ids(patch_grid, patch_grid, t=t, device=dev)
                     for t in frame_times], dim=0)
    h, w = latent_hw
    grid = spatial_ids(h // 2, w // 2, t=target_time, device=dev)
    vec = sum(vecs) / len(vecs)
    return {"txt": txt, "txt_ids": ids[None].expand(b, *ids.shape),
            "vec": vec.to(compute_dtype),
            "img_ids": grid[None].expand(b, (h // 2) * (w // 2), 3)}
